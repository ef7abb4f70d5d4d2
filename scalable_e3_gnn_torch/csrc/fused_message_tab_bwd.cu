// lmax=1 fused message + aggregation, backward, for Hopper (sm_90a): the
// tabled kernel (#2) and, by a compile-time sender addressing (Addr), the
// untabled slot-major one (#5) and the packed node-major one (#7).
//
// Replaces the TPU kernels scalable_e3_gnn_tpu/kernels/fused_message.py::
// _bwd_kernel_tab (via _bwd_tail, _layer_bwd, _accum_weight_grads), launched
// by _vjp_bwd_tab; with KM, _bwd_kernel_km (the default; _bwd_kernel_km2
// is its GEMM form), launched by _vjp_bwd_km; and with FLAT, _bwd_kernel (via
// _bwd_tail, the pack > 1 path), launched by _vjp_bwd.  Given the cotangent d_agg
// [Npad, F] of
//
//   agg[i] = sum_k mask[i,k] * MLP2(MLP1([h_s || h_r || d2], sh), sh),
//   h_s = h[gtab[i / tile, loc[i,k]]]  (loc == U: no sender),
//
// it recomputes both gated L1 tensor-product layers of every slot, runs their
// hand VJP and emits
//   d_hr [Npad, F]       the receiver cotangents, summed over each receiver's K slots;
//   d_hu [ntiles*U, F]   the sender cotangents folded into each tile's table;
//   partials [grid, NW]  per-block fp32 weight-gradient sums of the six blocks
//                        (W0a, W1Sa, W1Va, W0b, W1Sb, W1Vb; W1V unexpanded [V, hv]).
// With KM the senders come pre-gathered, hs3 [K, N, F] (slot k of receiver i
// is row k*N + i), the geometry from the node-major geo2 [N, K*6] (sh 4, d2,
// mask per slot), and each slot's rounded sender cotangent goes straight to
// row k*N + i of d_hs [K, N, F]: no scratch, no per-tile counting sort, no
// table sum; blocks walk over groups of receivers instead of tiles.  d_hr
// and the partials are as in the tabled kernel.  With FLAT the senders come
// pre-gathered node-major, hs [N*K, F] (slot k of receiver i is row e = i*K
// + k: the TPU's packed [N*K/p, p*F] rows are the same memory), the geometry
// from the flat d2, attr and maskf rows e, and the sender cotangent goes to
// row e of d_hs [N*K, F]; blocks walk over groups of receivers as with KM.
// The reduction kernels of this file sum the partials over the blocks in
// block order, so two runs give bit-identical weight gradients.  The split
// reverse-table epilogue that turns d_hu and d_hr into d_h stays in PyTorch,
// as it stays in XLA in the JAX package.
//
// Rounding points, as in the TPU kernel: the masked d_m, d_o1, d_o0, d_A,
// d_Xvs, d_f0, d_Xs and d_Xv are rounded to the data type; products and
// sums run in fp32; d_hu and d_hr are fp32 sums of rounded terms, written
// once in the data type.  FLAT rounds d_hr as the TPU's packed form
// (_bwd_tail with pack = p): the receiver parts of p slots summed in fp32 and
// rounded once, the K/p groups summed in fp32; pack = 1 is the tabled
// kernel's rounding.
//
// Design.  What the TPU kernel gets from its ordered grid, this kernel gets
// from ownership:
// - One block owns whole gather tiles (a persistent loop over tiles), so no
//   other block writes its d_hu rows.  Its fp32 [U, F] table accumulator
//   (205 KB at config 3) does not fit in shared memory beside the weights,
//   so the block writes each slot's rounded sender cotangent to its own
//   scratch rows in global memory, then, per tile, builds the inverse of loc
//   in shared memory (counting sort, each bucket sorted by slot) and sums
//   every table row's slots in slot order: no float atomics.
// - Each block's weight gradients are written once, into partials[block].
// - The TPU's one-hot MXU expansions (onehot, onehot^T, the E/E^T expand
//   matrices) are layouts for its matrix unit: here each slot reads its sender
//   row as h[gtab[tile, loc]] and receivers sum their K slots in order.
// bf16 (the engine of lmax1_mma.cuh): every product, forward, VJP and
// weight gradient, runs on the tensor cores (mma.sync m16n8k16, bf16
// operands, fp32 accumulators).  A block of eight warps (one an SM) walks
// rounds of 128 slot rows, a 16-row tile of each warp's unit of whole
// receivers: the recompute of both layers, the VJP of both gates and the
// input-cotangent products run per warp (layer 1 computed twice, for the
// layer-2 inputs and for its own VJP: its residuals held through layer 2
// would crowd the weight-gradient accumulators), the K-sum of d_hr per warp
// in slot order; the round's weight-gradient operands are staged in shared
// memory, and after one block barrier every warp accumulates 9 of the 72
// 16x8 weight-gradient tiles over the 128 rows, the products of two bf16
// values split into hi + lo bf16 (exact), in registers for the block's whole
// run.  Per 16 rows: about 450 mma.  The table sum fetches a bucket's scratch
// rows 8 at a time, several table rows a warp.
// Past 32x0e+16x1o the Wide kernel (below; an instance per count m of
// scalar and vector blocks, m = 1..4) runs the same rounds a column block at
// a time, its weights streamed through a ring of chunks, the layer-1 outputs
// in registers, its weight gradients in global memory.
// fp32 (the check path): the first form, kept: one block walks groups of G
// receivers (G*K slot rows, 48 at K=24), stages the layer-1 inputs, runs
// the small GEMMs of both layers forward and backward from shared memory on
// the fp32 FMA units (each thread a 4-row x 1-column register tile; the
// GEMMs of one phase share one work list), keeps the residuals of both
// layers for the VJP, and accumulates the weight gradients in shared memory,
// each entry owned by one thread.  Weights sit in shared memory with an odd
// row stride, so the transposed reads of the VJP are conflict-free.  A wide
// layer takes fewer receivers a group, then keeps its weight gradients (the
// block's partials row) and then its weights in global memory.
//
// Bound.  Per slot the recompute costs 10,816 multiply-adds at Hs=32, Hv=16
// and the VJP twice that (an input-gradient and a weight-gradient product for
// every forward product): 32,448, so about 136 GFLOP for the 2.09M valid
// slots of config 3, against about 150 MB of traffic.  The kernel is bound
// by operations (about 0.14 ms at the bf16 tensor-core peak).  With KM the
// kernel reads hs3 and writes d_hs, 384 MB each in bf16 at config 3, so it
// is bound by bytes (about 0.25 ms at 3.35 TB/s); so with FLAT, which reads
// hs and writes d_hs of the same size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// LMAX1_BWD_CLOCKS (a profiling build of kernels/lmax1_ab.py, never the
// package's library): thread 0 of each block of the bf16 engine adds the
// cycles of each phase of its rounds to bwd_phase_cycles[] (and the rounds
// to its last entry), read back by lmax1_bwd_phase_cycles.  No barrier is
// added: the phases are thread 0's (warp 0's tile, then the block's
// barriers and its share of the weight gradients).  The Bench and the Wide
// kernels mark the same phases; the Wide kernel's last one also holds the
// writing of its weight-gradient accumulators, and it marks three more
// (12-14: the wait before layer 2's jobs, warp 0's jobs of layer 2, the wait
// after them; its 8 is warp 0's jobs of layer 1) and adds thread 0's waits
// on the ring's mbarriers (inside the phases) to entry 15.
#ifdef LMAX1_BWD_CLOCKS
__device__ unsigned long long bwd_phase_cycles[16];
#define BWD_CLOCK(i)                                                           \
  do {                                                                         \
    if (threadIdx.x == 0) {                                                    \
      const long long now = clock64();                                         \
      atomicAdd(&bwd_phase_cycles[i], (unsigned long long)(now - clock_t0));   \
      clock_t0 = now;                                                          \
    }                                                                          \
  } while (0)
#else
#define BWD_CLOCK(i) \
  do {               \
  } while (0)
#endif

#include "lmax1_mma.cuh"

// LMAX1_WIDE=1: a library of the Wide kernels, of the instance LMAX1_WIDE_M
// (see launch_dtype)
#ifndef LMAX1_WIDE
#define LMAX1_WIDE 0
#endif

namespace {

using l1mma::Addr;
constexpr bool kWideLibrary = LMAX1_WIDE != 0;

constexpr float kCG110 = 0.57735026918962576451f;  // 1/sqrt(3)
constexpr float kCG011 = 0.57735026918962576451f;  // 1/sqrt(3)
constexpr int kThreads = 512;
constexpr int kMT = 4;           // rows per thread in the small GEMMs
constexpr int kTargetRows = 48;  // slot rows per group (G = max(1, 48 / K))
constexpr int kMaxMm = 6;        // GEMMs in one phase

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// x rounded to the data type and widened back to fp32
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__host__ __device__ inline int odd(int n) { return n | 1; }

struct Dims {
  int hs, hv, k, g, rows, rows_p;  // rows = g*k, rows_p = rows rounded to kMT
  int s1, v1, c0, f;               // 2hs+1, 2hv, hs+hv, hs+3hv
  int tile, u;
  int ld0a, ld1a, ld0b, ld1b;      // row strides of the weights (shared: odd; global: dense)
  bool gdw, gw;                    // the weight gradients, the weights in global memory
  long wts, nw;                    // floats: weights in shared memory, dense weight gradients
  long reg_a, reg_b;               // per-row floats of the two row regions
  long region;                     // floats of the whole row region (also the CSR ints)
};

// shared memory: weights, weight gradients, the row region, sender ids
__host__ __device__ inline long smem_bytes(const Dims& d) {
  return sizeof(float) * (d.wts + (d.gdw ? 0 : d.nw) + d.region) + sizeof(int) * d.rows_p;
}

// the row region and the weights' strides of d's group size and modes
__host__ __device__ inline void layout(Dims& d) {
  const int hs = d.hs, hv = d.hv, k = d.k;
  d.rows = d.g * k;
  d.rows_p = (d.rows + kMT - 1) / kMT * kMT;
  if (d.gw) {
    d.ld0a = d.c0; d.ld1a = hv; d.ld0b = d.c0; d.ld1b = hv;
    d.wts = 0;
  } else {
    d.ld0a = odd(d.c0); d.ld1a = odd(hv); d.ld0b = odd(d.c0); d.ld1b = odd(hv);
    d.wts = (long)(d.s1 + d.v1) * d.ld0a + (long)d.s1 * d.ld1a + (long)d.v1 * d.ld1a +
            (long)d.c0 * d.ld0b + (long)hs * d.ld1b + (long)hv * d.ld1b;
  }
  // A: XS1 [s1], X01 [s1+v1], XV1 [3 v1], O01 [c0], O11 [3 hv]; then OA [hv], GEO [5]
  d.reg_a = d.s1 + (d.s1 + d.v1) + 3L * d.v1 + d.c0 + 3L * hv;
  // B, layer 2: XS2 [hs], X02 [c0], XV2 [3hv], O02 [c0], O12 [3hv], DXV2 [3hv], DXS2 [hs], DF02 [c0]
  const long b2 = 2L * hs + 3L * d.c0 + 9L * hv;
  // B, layer 1: DXV1 [3 v1], DXS1 [2 hs], DF01 [s1+v1]
  const long b1 = 3L * d.v1 + 2L * hs + (d.s1 + d.v1);
  d.reg_b = b2 > b1 ? b2 : b1;
  const long rows_region = d.rows_p * (d.reg_a + hv + 5 + d.reg_b) + (long)d.g * d.f;
  const long csr = (long)d.tile * k + 2L * d.u + 1;  // PERM, START, CUR (ints)
  d.region = rows_region > csr ? rows_region : csr;
}

// tile = u = 0: the untabled kernels (KM, FLAT), which have no table.  A
// group holds G receivers (48 slot rows at most); past the shared memory
// of a wide layer, fewer, then the weight gradients and then the weights
// move to global memory (the block's partials row; the weight blocks as
// given).
__host__ __device__ inline Dims make_dims(int hs, int hv, int k, int tile, int u) {
  Dims d;
  d.hs = hs; d.hv = hv; d.k = k; d.tile = tile; d.u = u;
  d.s1 = 2 * hs + 1; d.v1 = 2 * hv; d.c0 = hs + hv; d.f = hs + 3 * hv;
  d.nw = (long)(d.s1 + d.v1) * d.c0 + (long)d.s1 * hv + (long)d.v1 * hv + (long)d.c0 * d.c0 +
         (long)hs * hv + (long)hv * hv;
  d.gdw = d.gw = false;
  d.g = k >= kTargetRows ? 1 : kTargetRows / k;
  if (tile > 0 && d.g > tile) d.g = tile;
  for (;; --d.g) {
    layout(d);
    if (d.g == 1 || smem_bytes(d) <= gmma::kMaxSmem) break;
  }
  if (smem_bytes(d) > gmma::kMaxSmem) d.gdw = true;
  if (smem_bytes(d) > gmma::kMaxSmem) {
    d.gw = true;
    layout(d);
  }
  return d;
}

// Y[m][n] (+)= sum_kk A(m, kk) B(kk, n), A(m, kk) = a[m*sam + kk*sak],
// B(kk, n) = b[kk*sbk + n*sbn]; all in shared memory.
struct Mm {
  const float* a; int sam, sak;
  const float* b; int sbk, sbn;
  float* y; int ldy;
  int m, n, kd, acc;
};

__device__ __forceinline__ Mm mm(const float* a, int sam, int sak, const float* b, int sbk,
                                 int sbn, float* y, int ldy, int m, int n, int kd, int acc) {
  Mm g;
  g.a = a; g.sam = sam; g.sak = sak; g.b = b; g.sbk = sbk; g.sbn = sbn;
  g.y = y; g.ldy = ldy; g.m = m; g.n = n; g.kd = kd; g.acc = acc;
  return g;
}

// Run a phase's GEMMs as one work list of (4 rows x 1 column) items.  Each
// output entry belongs to one item, so accumulation needs no atomics.
__device__ void run_mms(const Mm* mms, int count) {
  int items[kMaxMm];
  int total = 0;
  for (int q = 0; q < count; ++q) {
    items[q] = (mms[q].m + kMT - 1) / kMT * mms[q].n;
    total += items[q];
  }
  for (int w = threadIdx.x; w < total; w += blockDim.x) {
    int q = 0, base = w;
    while (base >= items[q]) { base -= items[q]; ++q; }
    const Mm g = mms[q];
    const int n = base % g.n;
    const int m0 = (base / g.n) * kMT;
    const float* arow[kMT];
#pragma unroll
    for (int t = 0; t < kMT; ++t) arow[t] = g.a + (long)min(m0 + t, g.m - 1) * g.sam;
    float acc[kMT];
#pragma unroll
    for (int t = 0; t < kMT; ++t) acc[t] = 0.0f;
    const float* bcol = g.b + (long)n * g.sbn;
    for (int kk = 0; kk < g.kd; ++kk) {
      const float bv = bcol[(long)kk * g.sbk];
#pragma unroll
      for (int t = 0; t < kMT; ++t) acc[t] = fmaf(arow[t][(long)kk * g.sak], bv, acc[t]);
    }
#pragma unroll
    for (int t = 0; t < kMT; ++t) {
      if (m0 + t < g.m) {
        float* y = g.y + (long)(m0 + t) * g.ldy + n;
        *y = g.acc ? *y + acc[t] : acc[t];
      }
    }
  }
}

// KM: h is hr [N, F], the sender rows come from hsp = hs3 [K, N, F], the
// geometry from geo2 [N, K*6], and the sender cotangents go to dhsp [K, N,
// F]; d2, attr, maskf, loc, gtab, dhu and dhs_scratch are unused (tile = u =
// 0).  FLAT: as KM, but hsp = hs and dhsp = d_hs are [N*K, F], node-major,
// and the geometry comes from d2, attr, maskf (geo2 unused); pack is d_hr's
// group size (1 for the others).
template <typename T, Addr A>
__global__ void __launch_bounds__(kThreads, 1)
fused_message_tab_bwd_kernel(const T* __restrict__ h, const T* __restrict__ d2,
                             const T* __restrict__ attr, const T* __restrict__ maskf,
                             const int* __restrict__ loc, const int* __restrict__ gtab,
                             const T* __restrict__ hsp, const T* __restrict__ geo2,
                             const T* __restrict__ w0a, const T* __restrict__ w1sa,
                             const T* __restrict__ w1va, const T* __restrict__ w0b,
                             const T* __restrict__ w1sb, const T* __restrict__ w1vb,
                             const T* __restrict__ dagg, T* __restrict__ dhu,
                             T* __restrict__ dhr, T* __restrict__ dhs_scratch,
                             T* __restrict__ dhsp, float* __restrict__ partials, int npad,
                             int hs, int hv, int k, int tile, int u, int pack) {
  constexpr bool KM = A == Addr::kKm;
  constexpr bool TAB = A == Addr::kTab;
  const Dims d = make_dims(hs, hv, k, tile, u);
  const T* __restrict__ hsrc = TAB ? h : hsp;  // where SND rows point
  const int R = d.rows_p, s1 = d.s1, v1 = d.v1, c0 = d.c0, f = d.f;
  extern __shared__ float smem[];
  // weights (padded rows) and the weight gradients (dense, in the partials'
  // order), in shared memory unless the widths move them to global memory
  float* W0a = smem;                        // [s1+v1][ld0a]
  float* W1Sa = W0a + (s1 + v1) * d.ld0a;   // [s1][ld1a]
  float* W1Va = W1Sa + s1 * d.ld1a;         // [v1][ld1a]
  float* W0b = W1Va + v1 * d.ld1a;          // [c0][ld0b]
  float* W1Sb = W0b + c0 * d.ld0b;          // [hs][ld1b]
  float* W1Vb = W1Sb + hs * d.ld1b;         // [hv][ld1b]
  if (d.gw) {  // as given (fp32: T is float)
    W0a = const_cast<float*>(w0a); W1Sa = const_cast<float*>(w1sa);
    W1Va = const_cast<float*>(w1va); W0b = const_cast<float*>(w0b);
    W1Sb = const_cast<float*>(w1sb); W1Vb = const_cast<float*>(w1vb);
  }
  float* DW = d.gdw ? partials + (long)blockIdx.x * d.nw : smem + d.wts;
  float* dW0a = DW;
  float* dW1Sa = dW0a + (s1 + v1) * c0;
  float* dW1Va = dW1Sa + s1 * hv;
  float* dW0b = dW1Va + v1 * hv;
  float* dW1Sb = dW0b + c0 * c0;
  float* dW1Vb = dW1Sb + hs * hv;
  float* RG = smem + d.wts + (d.gdw ? 0 : d.nw);
  int* SND = reinterpret_cast<int*>(RG + d.region);  // [R] sender row in hsrc, or -1
  // region A: the layer-1 residuals (later the receiver cotangents RHR)
  float* XS1 = RG;                 // [R][s1]      xs = [h_s || h_r || d2]
  float* X01 = XS1 + R * s1;       // [R][s1+v1]   f0
  float* XV1 = X01 + R * (s1 + v1);  // [3R][v1]   xv * s
  float* O01 = XV1 + 3 * R * v1;   // [R][c0]      o0, then d_o0
  float* O11 = O01 + R * c0;       // [3R][hv]     o1, then d_B
  float* OA = O11 + 3 * R * hv;    // [R][hv]      A, then d_A
  float* GEO = OA + R * hv;        // [R][5]       s, vx, vy, vz, mask
  float* DAGG = GEO + R * 5;       // [G][f]
  float* B = DAGG + d.g * f;
  // region B, layer 2
  float* XS2 = B;                  // [R][hs]      m0
  float* X02 = XS2 + R * hs;       // [R][c0]      f0
  float* XV2 = X02 + R * c0;       // [3R][hv]     m1 * s
  float* O02 = XV2 + 3 * R * hv;   // [R][c0]      o0, then d_o0
  float* O12 = O02 + R * c0;       // [3R][hv]     B, then d_B
  float* DXV2 = O12 + 3 * R * hv;  // [3R][hv]     d_Xvs, then d_Xv (layer-1 d_m1)
  float* DXS2 = DXV2 + 3 * R * hv; // [R][hs]      d_Xs (layer-1 d_m0)
  float* DF02 = DXS2 + R * hs;     // [R][c0]      d_f0
  // region B, layer 1 (after DXV2/DXS2 are read)
  float* DXV1 = B;                 // [3R][v1]
  float* DXS1 = DXV1 + 3 * R * v1; // [R][2hs]
  float* DF01 = DXS1 + R * 2 * hs; // [R][s1+v1]
  float* RHR = XS1;                // [R][f]       receiver parts of the layer-1 cotangents
  // per-tile inverse of loc (after the tile's groups)
  int* PERM = reinterpret_cast<int*>(RG);  // [tile*k] slots grouped by table entry
  int* START = PERM + tile * k;            // [u+1]
  int* CUR = START + u + 1;                // [u]

  {
    const T* src[6] = {w0a, w1sa, w1va, w0b, w1sb, w1vb};
    float* dst[6] = {W0a, W1Sa, W1Va, W0b, W1Sb, W1Vb};
    const int nr[6] = {s1 + v1, s1, v1, c0, hs, hv};
    const int nc[6] = {c0, hv, hv, c0, hv, hv};
    const int ld[6] = {d.ld0a, d.ld1a, d.ld1a, d.ld0b, d.ld1b, d.ld1b};
    for (int m = 0; m < 6 && !d.gw; ++m)
      for (int i = threadIdx.x; i < nr[m] * nc[m]; i += blockDim.x)
        dst[m][(i / nc[m]) * ld[m] + i % nc[m]] = to_f(src[m][i]);
    for (long i = threadIdx.x; i < d.nw; i += blockDim.x) DW[i] = 0.0f;
  }
  __syncthreads();

  // the units a block owns: whole tiles (tabled), or groups of G receivers
  const int units = TAB ? npad / tile : (npad + d.g - 1) / d.g;
  const int span = TAB ? tile : d.g;  // receivers per unit
  const int slots = span * k;
  T* dhs = TAB ? dhs_scratch + (long)blockIdx.x * slots * f : nullptr;
  const int ngroups = TAB ? (tile + d.g - 1) / d.g : 1;
  for (int tl = blockIdx.x; tl < units; tl += gridDim.x) {
    // receivers of this unit: the last group of an untabled launch may be short
    const int end = TAB ? span : min(span, npad - tl * span);
    for (int gi = 0; gi < ngroups; ++gi) {
      const int first = gi * d.g;  // first receiver of the group within the unit
      const int node0 = tl * span + first;
      // ---- 1. sender ids, geometry, d_agg rows
      for (int r = threadIdx.x; r < R; r += blockDim.x) {
        const int i = r / k;
        int snd = -1;
        float g5[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
        float dd = 0.f;
        if (r < d.rows && first + i < end) {
          const long e = (long)(node0 + i) * k + r % k;
          if (KM) {
            snd = (r % k) * npad + node0 + i;  // K*N < 2^31, checked by the wrapper
            const T* g = geo2 + e * 6;         // sh 4, d2, mask
#pragma unroll
            for (int q = 0; q < 4; ++q) g5[q] = to_f(g[q]);
            g5[4] = to_f(g[5]);
            dd = to_f(g[4]);
          } else {
            if (A == Addr::kFlat) {
              snd = (int)e;  // N*K < 2^31, checked by the wrapper
            } else {
              const int l = loc[e];
              if (l < u) {
                const int t = gtab[(long)tl * u + l];
                snd = (t >= 0 && t < npad) ? t : -1;
              }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) g5[q] = to_f(attr[e * 4 + q]);
            g5[4] = to_f(maskf[e]);
            dd = to_f(d2[e]);
          }
        }
        SND[r] = snd;
        XS1[r * s1 + 2 * hs] = dd;
#pragma unroll
        for (int q = 0; q < 5; ++q) GEO[r * 5 + q] = g5[q];
      }
      for (int w = threadIdx.x; w < d.g * f; w += blockDim.x) {
        const int i = w / f;
        DAGG[w] = first + i < end ? to_f(dagg[(long)(node0 + i) * f + w % f]) : 0.f;
      }
      __syncthreads();

      // ---- 2. layer-1 inputs: xs = [hs0e || hr0e || d2], xv_c = [hs_c || hr_c]
      {
        const int width = 2 * hs + v1;
        for (int w = threadIdx.x; w < R * width; w += blockDim.x) {
          const int r = w / width, j = w % width;
          const int node = node0 + r / k;
          const bool live = r < d.rows && first + r / k < end;
          const int snd = SND[r];
          const float s = GEO[r * 5];
          if (j < 2 * hs) {
            float x = 0.f;
            if (j < hs) {
              if (snd >= 0) x = to_f(hsrc[(long)snd * f + j]);
            } else if (live) {
              x = to_f(h[(long)node * f + (j - hs)]);
            }
            XS1[r * s1 + j] = x;
            X01[r * (s1 + v1) + j] = x * s;
          } else {
            const int jj = j - 2 * hs;  // lane in [0, v1)
            float dot = 0.f;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              float x = 0.f;
              if (jj < hv) {
                if (snd >= 0) x = to_f(hsrc[(long)snd * f + hs + c * hv + jj]);
              } else if (live) {
                x = to_f(h[(long)node * f + hs + c * hv + (jj - hv)]);
              }
              XV1[(r * 3 + c) * v1 + jj] = x * s;
              dot = fmaf(x, GEO[r * 5 + 1 + c], dot);
            }
            X01[r * (s1 + v1) + s1 + jj] = kCG110 * dot;
          }
        }
        for (int r = threadIdx.x; r < R; r += blockDim.x)
          X01[r * (s1 + v1) + 2 * hs] = XS1[r * s1 + 2 * hs] * GEO[r * 5];
      }
      __syncthreads();

      // ---- 3. layer-1 products: o0 = f0 W0a, A = xs W1Sa, B = xvs W1Va
      {
        const Mm l[3] = {mm(X01, s1 + v1, 1, W0a, d.ld0a, 1, O01, c0, R, c0, s1 + v1, 0),
                         mm(XS1, s1, 1, W1Sa, d.ld1a, 1, OA, hv, R, hv, s1, 0),
                         mm(XV1, v1, 1, W1Va, d.ld1a, 1, O11, hv, 3 * R, hv, v1, 0)};
        run_mms(l, 3);
      }
      __syncthreads();

      // ---- 4. layer-1 gates -> o1 (kept) and the layer-2 inputs (rounded)
      for (int w = threadIdx.x; w < R * c0; w += blockDim.x) {
        const int r = w / c0, j = w % c0;
        const float s = GEO[r * 5];
        if (j < hs) {
          const float o = O01[r * c0 + j];
          const float m0 = rnd<T>(o * sigmoid_f(o));
          XS2[r * hs + j] = m0;
          X02[r * c0 + j] = m0 * s;
        } else {
          const int jj = j - hs;
          const float g = sigmoid_f(O01[r * c0 + j]);
          const float a = OA[r * hv + jj];
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float v = GEO[r * 5 + 1 + c];
            const int idx = (r * 3 + c) * hv + jj;
            const float o1 = kCG011 * fmaf(v, a, O11[idx]);
            O11[idx] = o1;
            const float m1 = rnd<T>(o1 * g);
            XV2[idx] = m1 * s;
            dot = fmaf(m1, v, dot);
          }
          X02[r * c0 + j] = kCG110 * dot;
        }
      }
      __syncthreads();

      // ---- 5. layer-2 products
      {
        const Mm l[3] = {mm(X02, c0, 1, W0b, d.ld0b, 1, O02, c0, R, c0, c0, 0),
                         mm(XS2, hs, 1, W1Sb, d.ld1b, 1, OA, hv, R, hv, hs, 0),
                         mm(XV2, hv, 1, W1Vb, d.ld1b, 1, O12, hv, 3 * R, hv, hv, 0)};
        run_mms(l, 3);
      }
      __syncthreads();

      // ---- 6. layer-2 VJP through the gates: d_m = rnd(d_agg * mask);
      //         d_o0 -> O02, d_B = cg011 * d_o1 -> O12, d_A -> OA
      for (int w = threadIdx.x; w < R * c0; w += blockDim.x) {
        const int r = w / c0, j = w % c0;
        const bool row = r < d.rows;
        const float mk = GEO[r * 5 + 4];
        const float* dg = DAGG + (row ? r / k : 0) * f;
        if (j < hs) {
          const float o = O02[r * c0 + j];
          const float sg = sigmoid_f(o);
          const float dm0 = row ? rnd<T>(dg[j] * mk) : 0.f;
          O02[r * c0 + j] = rnd<T>(dm0 * (sg * (1.0f + o * (1.0f - sg))));
        } else {
          const int jj = j - hs;
          const float g = sigmoid_f(O02[r * c0 + j]);
          const float a = OA[r * hv + jj];
          float d_g = 0.f, d_a = 0.f;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float v = GEO[r * 5 + 1 + c];
            const int idx = (r * 3 + c) * hv + jj;
            const float o1 = kCG011 * fmaf(v, a, O12[idx]);
            const float dm1 = row ? rnd<T>(dg[hs + c * hv + jj] * mk) : 0.f;
            d_g = fmaf(dm1, o1, d_g);
            const float d_o1 = rnd<T>(dm1 * g);
            O12[idx] = kCG011 * d_o1;
            d_a = fmaf(d_o1, v, d_a);
          }
          O02[r * c0 + j] = rnd<T>(d_g * (g * (1.0f - g)));
          OA[r * hv + jj] = rnd<T>(kCG011 * d_a);
        }
      }
      __syncthreads();

      // ---- 7. layer-2 input cotangents and weight gradients
      {
        const Mm l[6] = {
            mm(O12, hv, 1, W1Vb, 1, d.ld1b, DXV2, hv, 3 * R, hv, hv, 0),   // d_B W1Vb^T
            mm(OA, hv, 1, W1Sb, 1, d.ld1b, DXS2, hs, R, hs, hv, 0),        // d_A W1Sb^T
            mm(O02, c0, 1, W0b, 1, d.ld0b, DF02, c0, R, c0, c0, 0),        // d_o0 W0b^T
            mm(X02, 1, c0, O02, c0, 1, dW0b, c0, c0, c0, R, 1),            // f0^T d_o0
            mm(XS2, 1, hs, OA, hv, 1, dW1Sb, hv, hs, hv, R, 1),            // xs^T d_A
            mm(XV2, 1, hv, O12, hv, 1, dW1Vb, hv, hv, hv, 3 * R, 1)};      // xvs^T d_B
        run_mms(l, 6);
      }
      __syncthreads();

      // ---- 8. layer-2 d_Xs = rnd(d_A W1S^T + rnd(d_f0)[:hs] s) -> DXS2,
      //         d_Xv = rnd(rnd(d_Xvs) s + cg110 rnd(d_f0)[hs:] v) -> DXV2
      for (int w = threadIdx.x; w < R * c0; w += blockDim.x) {
        const int r = w / c0, j = w % c0;
        const float s = GEO[r * 5];
        const float df = rnd<T>(DF02[r * c0 + j]);
        if (j < hs) {
          DXS2[r * hs + j] = rnd<T>(DXS2[r * hs + j] + df * s);
        } else {
          const int jj = j - hs;
          const float d_dot = kCG110 * df;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int idx = (r * 3 + c) * hv + jj;
            DXV2[idx] = rnd<T>(rnd<T>(DXV2[idx]) * s + d_dot * GEO[r * 5 + 1 + c]);
          }
        }
      }
      __syncthreads();

      // ---- 9. layer-1 VJP through the gates: d_o0 -> O01, d_B -> O11, d_A -> OA
      for (int w = threadIdx.x; w < R * c0; w += blockDim.x) {
        const int r = w / c0, j = w % c0;
        if (j < hs) {
          const float o = O01[r * c0 + j];
          const float sg = sigmoid_f(o);
          O01[r * c0 + j] = rnd<T>(DXS2[r * hs + j] * (sg * (1.0f + o * (1.0f - sg))));
        } else {
          const int jj = j - hs;
          const float g = sigmoid_f(O01[r * c0 + j]);
          float d_g = 0.f, d_a = 0.f;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int idx = (r * 3 + c) * hv + jj;
            const float dm1 = DXV2[idx];
            d_g = fmaf(dm1, O11[idx], d_g);
            const float d_o1 = rnd<T>(dm1 * g);
            O11[idx] = kCG011 * d_o1;
            d_a = fmaf(d_o1, GEO[r * 5 + 1 + c], d_a);
          }
          O01[r * c0 + j] = rnd<T>(d_g * (g * (1.0f - g)));
          OA[r * hv + jj] = rnd<T>(kCG011 * d_a);
        }
      }
      __syncthreads();

      // ---- 10. layer-1 input cotangents (d2's lane is geometry: not needed)
      //          and weight gradients
      {
        const Mm l[6] = {
            mm(O11, hv, 1, W1Va, 1, d.ld1a, DXV1, v1, 3 * R, v1, hv, 0),    // d_B W1Va^T
            mm(OA, hv, 1, W1Sa, 1, d.ld1a, DXS1, 2 * hs, R, 2 * hs, hv, 0), // d_A W1Sa^T
            mm(O01, c0, 1, W0a, 1, d.ld0a, DF01, s1 + v1, R, s1 + v1, c0, 0),  // d_o0 W0a^T
            mm(X01, 1, s1 + v1, O01, c0, 1, dW0a, c0, s1 + v1, c0, R, 1),
            mm(XS1, 1, s1, OA, hv, 1, dW1Sa, hv, s1, hv, R, 1),
            mm(XV1, 1, v1, O11, hv, 1, dW1Va, hv, v1, hv, 3 * R, 1)};
        run_mms(l, 6);
      }
      __syncthreads();

      // ---- 11. layer-1 d_Xs, d_Xv: sender parts -> the block's d_hs rows
      //          (KM: row k*N + i of d_hs; FLAT: row i*K + k), receiver
      //          parts -> RHR
      {
        const int width = 2 * hs + v1;
        for (int w = threadIdx.x; w < R * width; w += blockDim.x) {
          const int r = w / width, j = w % width;
          if (r >= d.rows || first + r / k >= end) continue;
          const float s = GEO[r * 5];
          T* out = KM ? dhsp + ((long)(r % k) * npad + node0 + r / k) * f
                   : TAB ? dhs + (long)(first * k + r) * f
                         : dhsp + ((long)node0 * k + r) * f;
          if (j < 2 * hs) {
            const float val = rnd<T>(DXS1[r * 2 * hs + j] + rnd<T>(DF01[r * (s1 + v1) + j]) * s);
            if (j < hs) out[j] = from_f<T>(val);
            else RHR[r * f + (j - hs)] = val;
          } else {
            const int jj = j - 2 * hs;
            const float d_dot = kCG110 * rnd<T>(DF01[r * (s1 + v1) + s1 + jj]);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float val = rnd<T>(rnd<T>(DXV1[(r * 3 + c) * v1 + jj]) * s +
                                       d_dot * GEO[r * 5 + 1 + c]);
              if (jj < hv) out[hs + c * hv + jj] = from_f<T>(val);
              else RHR[r * f + hs + c * hv + (jj - hv)] = val;
            }
          }
        }
      }
      __syncthreads();

      // ---- 12. d_hr: each receiver's K slots summed in fp32 (FLAT: groups
      //          of pack slots summed in fp32 and rounded, then added)
      for (int w = threadIdx.x; w < d.g * f; w += blockDim.x) {
        const int i = w / f, col = w % f;
        if (first + i >= end) continue;
        float acc = 0.f, gsum = 0.f;
        for (int kk = 0; kk < k; ++kk) {
          if (A == Addr::kFlat) {
            gsum += RHR[(i * k + kk) * f + col];
            if ((kk + 1) % pack == 0) {
              acc += rnd<T>(gsum);
              gsum = 0.f;
            }
          } else {
            acc += RHR[(i * k + kk) * f + col];
          }
        }
        dhr[(long)(node0 + i) * f + col] = from_f<T>(acc);
      }
      __syncthreads();
    }

    if (!TAB) continue;
    // ---- the tile's table rows: d_hu[u] = sum of the d_hs rows of the
    //      tile's slots with loc == u, in slot order
    const int* tloc = loc + (long)tl * slots;
    for (int i = threadIdx.x; i < u; i += blockDim.x) CUR[i] = 0;
    __syncthreads();
    for (int sl = threadIdx.x; sl < slots; sl += blockDim.x) {
      const int l = tloc[sl];
      if (l < u) atomicAdd(&CUR[l], 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int run = 0;
      for (int i = 0; i < u; ++i) {
        START[i] = run;
        run += CUR[i];
        CUR[i] = 0;
      }
      START[u] = run;
    }
    __syncthreads();
    for (int sl = threadIdx.x; sl < slots; sl += blockDim.x) {
      const int l = tloc[sl];
      if (l < u) PERM[START[l] + atomicAdd(&CUR[l], 1)] = sl;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < u; i += blockDim.x) {  // each bucket in slot order
      for (int p = START[i] + 1; p < START[i + 1]; ++p) {
        const int x = PERM[p];
        int q = p - 1;
        while (q >= START[i] && PERM[q] > x) {
          PERM[q + 1] = PERM[q];
          --q;
        }
        PERM[q + 1] = x;
      }
    }
    __syncthreads();
    for (int w = threadIdx.x; w < u * f; w += blockDim.x) {
      const int i = w / f, col = w % f;
      float acc = 0.f;
      for (int p = START[i]; p < START[i + 1]; ++p) acc += to_f(dhs[(long)PERM[p] * f + col]);
      dhu[((long)tl * u + i) * f + col] = from_f<T>(acc);
    }
    __syncthreads();
  }

  for (long i = threadIdx.x; i < d.nw && !d.gdw; i += blockDim.x)
    partials[(long)blockIdx.x * d.nw + i] = DW[i];
}

// The fixed-order reduction: out[w] = sum over blocks b = 0..n-1, in order,
// of partials[b][w] (the port's form of the TPU's grid-sequential
// _accum_weight_grads, fused_message.py:485).  Every weight gradient of the
// port goes through it: #2, #5, #7, and the weight-gradient kernels of
// #9, #10, #12, #13 and #14 (#14 folds a group of tiles onto its running
// sum, row 0).
//
// Bound: bytes, the partials read once and the sums written once (4.9 MB at
// config 3's [132, 9280]: 1.5 us at 3.35 TB/s).  Each column is summed by one
// thread in row order, so the output is the in-order fold bit for bit
// whichever kernel runs and however the rows are fetched.  A loop of loads
// and adds, one column a thread, keeps too few bytes in flight; the two
// kernels below fetch the rows ahead of the adds:
// - reduce_strips (any NW and alignment; taken where the other does not
//   apply or would leave SMs without a block): a block of kStripWarps warps
//   owns kStripCols columns.
//   All its warps load a stage of kStripRows rows into shared memory
//   (kStripRows / kStripWarps loads in flight a thread, all issued at once),
//   then warp 0 adds the stage in row order while the others fetch the next
//   stage into registers.  At config 3 the 132 rows are one stage: one trip
//   to L2 for the whole strip.
// - reduce_cols (wide NW, a multiple of 4, both bases 16-byte aligned:
//   #9-#14's 263,412 weights): one thread owns 4 columns, one 16-byte load
//   a row, and issues the loads of kColRows rows before the first add of
//   the batch.
// The wrapper's plan (kernels/fused_message.py::reduce_plan) picks one.
constexpr int kStripCols = 32;
constexpr int kStripWarps = 8;
constexpr int kStripRows = 136;
constexpr int kColThreads = 64;
constexpr int kColRows = 16;

__global__ void __launch_bounds__(kStripWarps * 32)
    fused_message_tab_bwd_reduce_strips(const float* __restrict__ partials,
                                        float* __restrict__ out, int nblocks, int nw) {
  __shared__ float stage[2][kStripRows][kStripCols];
  constexpr int kPer = kStripRows / kStripWarps;  // rows a thread loads per stage
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kStripCols + lane;
  const bool live = col < nw;
  float v[kPer];
  auto fetch = [&](int b0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int b = b0 + warp + i * kStripWarps;
      v[i] = live && b < nblocks ? __ldg(partials + (long long)b * nw + col) : 0.f;
    }
  };
  float acc = 0.f;
  fetch(0);
  int s = 0;
  for (int b0 = 0; b0 < nblocks; b0 += kStripRows, s ^= 1) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) stage[s][warp + i * kStripWarps][lane] = v[i];
    // also orders warp 0's adds of the previous stage (buffer s ^ 1)
    // before the next iteration's stores into it
    __syncthreads();
    if (b0 + kStripRows < nblocks) fetch(b0 + kStripRows);
    if (warp == 0) {
      const int rows = nblocks - b0 < kStripRows ? nblocks - b0 : kStripRows;
      for (int j = 0; j < rows; ++j) acc += stage[s][j][lane];
    }
  }
  if (warp == 0 && live) out[col] = acc;
}

__global__ void __launch_bounds__(kColThreads)
    fused_message_tab_bwd_reduce_cols(const float4* __restrict__ partials,
                                      float4* __restrict__ out, int nblocks, int nv) {
  const int w = blockIdx.x * kColThreads + threadIdx.x;
  if (w >= nv) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int b0 = 0; b0 < nblocks; b0 += kColRows) {
    float4 v[kColRows];
#pragma unroll
    for (int j = 0; j < kColRows; ++j)
      if (b0 + j < nblocks) v[j] = __ldg(partials + (long long)(b0 + j) * nv + w);
#pragma unroll
    for (int j = 0; j < kColRows; ++j) {
      if (b0 + j < nblocks) {
        acc.x += v[j].x;
        acc.y += v[j].y;
        acc.z += v[j].z;
        acc.w += v[j].w;
      }
    }
  }
  out[w] = acc;
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core engine (lmax1_mma.cuh).  A block of eight warps walks
// rounds of 128 slot rows: in a round every warp runs one 16-row tile of its
// unit (G whole receivers) through the recompute of both layers, the VJP of
// both gates and the input-cotangent products, all in registers, writes the
// tile's sender cotangents (TAB: to the block's scratch rows), adds its
// receiver parts to the running K-sums of d_hr, and stages the weight
// gradients' operands of its rows (the layer-2 inputs m0, m1 and the
// rounded cotangents d_o0, d_a, d_o1 of both layers) in shared memory.  Then
// one block barrier, and every warp multiplies its share of the weight
// gradients (dW = X^T dY, 9 of the 72 16x8 tiles a warp) over the round's
// 128 rows: X^T by ldmatrix.trans from the staged rows and from the gather
// buffers (the layer-1 inputs), dY by ldmatrix.trans, s d_o0 and s d_o1
// split into hi + lo bf16 in registers, the dot lanes' fp32 dot split into
// three bf16 parts.  The accumulators stay in registers for the block's
// whole run and are written once, into partials[block].  A second barrier
// frees the staging for the next round.
namespace mma {

using l1mma::align16; using l1mma::bf; using l1mma::bf16; using l1mma::buf_bytes;
using l1mma::Buf; using l1mma::carve_buf; using l1mma::copy_mode; using l1mma::cp_async_commit;
using l1mma::cp_async_wait; using l1mma::fits; using l1mma::gate1; using l1mma::gather_tile;
using l1mma::GatherArgs; using l1mma::kC0; using l1mma::kCG;
using l1mma::kCopy2; using l1mma::kHS; using l1mma::kHV;
using l1mma::kLdF; using l1mma::kLdK; using l1mma::kLdW; using l1mma::ldsm_x4; using l1mma::kN; using l1mma::KSum; using l1mma::ksum_init;
using l1mma::ksum_tile; using l1mma::kW1s; using l1mma::kW1v;
using l1mma::kW2s; using l1mma::kW2v; using l1mma::kWRows; using l1mma::layer1;
using l1mma::layer2; using l1mma::ldsm_x2_t; using l1mma::ldsm_x4_t; using l1mma::mma_bf16_16816; using l1mma::mma_pairT;
using l1mma::pack; using l1mma::rnd; using l1mma::row_geo; using l1mma::RowGeo; using l1mma::sigm;
using l1mma::stage_weights; using l1mma::TileRef; using l1mma::unit_recv; using l1mma::unit_tiles;
using l1mma::store_a; using l1mma::weight_bytes; using l1mma::zero;

// A block: eight warps, one an SM.  The 72 16x8 weight-gradient tiles
// spread over them, 9 a warp (36 registers held through the tile phase;
// four warps holding 18 each ran out of registers).
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles = 9;
constexpr int kRound = 16 * kWarps;  // slot rows a round
constexpr int kLdY = 120;            // staged cotangent rows: d_o0 48 | d_a 16 | d_o1 3 x 16
constexpr int kY0 = 0, kYa = kC0, kY1 = kN;

__host__ __device__ inline long staging_bytes() {
  return align16(2L * kRound * kLdF) + 2 * align16(2L * kRound * kLdY);
}
// the table sum's ints (TAB): PERM [tile*k], START [u+1], CUR [u]
__host__ __device__ inline long csr_bytes(int k, int tile, int u) {
  return align16(4L * ((long)tile * k + 2L * u + 1));
}
__host__ __device__ inline long warp_bytes(int k) {
  return 2 * buf_bytes(k, true) + align16(2L * 16 * kLdK);
}
// shared memory: the weights; the per-warp gather and K-sum buffers; the
// d2 rows' per-warp sums [kWarps][kN] fp32; the round's staging (aliased by
// the table sum's ints)
__host__ __device__ inline long smem_bytes(int k, int tile, int u) {
  const long st = staging_bytes(), csr = tile > 0 ? csr_bytes(k, tile, u) : 0;
  return weight_bytes() + kWarps * warp_bytes(k) + align16(4L * kWarps * kN) +
         (st > csr ? st : csr);
}

// a bf16 pair (rows r, r + 1 of a B fragment) times s0, s1: the exact fp32
// products as hi + lo bf16 pairs
__device__ __forceinline__ void split2(uint32_t v, float s0, float s1, uint32_t& hi,
                                       uint32_t& lo) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  const float p0 = x.x * s0, p1 = x.y * s1;
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(p0 - hf.x, p1 - hf.y);
}

// The VJP of a gate layer on C fragments: the pre-gate o0 [6 n-tiles], A [2]
// and B_c [3][2] of the layer, and d_m from dm(pc, h) (padded column pc of
// the lane's row g + 8 h).  Rounds as _layer_vjp: o1 = CG011 (v_c A + B_c),
// d_o0 = [d_m0 silu'(o0) || d_g g (1 - g)], d_o1 = d_m1 g, d_a = CG011
// sum_c d_o1 v_c, each to bf16, stored into the staging rows r0 .. r0+15 of
// Y ([d_o0 | d_a | d_o1_0 | d_o1_1 | d_o1_2]): the weight gradients' dY and
// the A operands of the input-cotangent products.
template <typename DM>
__device__ __forceinline__ void gate_vjp(const float (&o0)[6][4], const float (&oa)[2][4],
                                         const float (&ob)[3][2][4], DM dm, const RowGeo& rg,
                                         bf16* Y, int r0, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  auto put = [&](int h, int col, float x0, float x1) {
    *reinterpret_cast<__nv_bfloat162*>(Y + (r0 + g + 8 * h) * kLdY + col + 2 * t4) =
        __floats2bfloat162_rn(x0, x1);
  };
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    float x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float o = o0[nt][q], sg = sigm(o);
      x[q] = dm(nt * 8 + 2 * t4 + (q & 1), q >> 1) * (sg * (1.0f + o * (1.0f - sg)));
    }
    put(0, kY0 + nt * 8, x[0], x[1]);
    put(1, kY0 + nt * 8, x[2], x[3]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float xg[4], xa[4], x1[3][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int h = q >> 1;
      const float gv = sigm(o0[4 + i][q]);
      float d_g = 0.f, d_a = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float d = dm(kHS + kHV * c + 8 * i + 2 * t4 + (q & 1), h);
        d_g = fmaf(d, kCG * fmaf(rg.v(h, c), oa[i][q], ob[c][i][q]), d_g);
        const float d_o1 = rnd(d * gv);
        x1[c][q] = d_o1;
        d_a = fmaf(d_o1, rg.v(h, c), d_a);
      }
      xg[q] = d_g * (gv * (1.0f - gv));
      xa[q] = kCG * d_a;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      put(h, kY0 + kHS + 8 * i, xg[2 * h], xg[2 * h + 1]);
      put(h, kYa + 8 * i, xa[2 * h], xa[2 * h + 1]);
#pragma unroll
      for (int c = 0; c < 3; ++c) put(h, kY1 + kHV * c + 8 * i, x1[c][2 * h], x1[c][2 * h + 1]);
    }
  }
}

__device__ __forceinline__ float lo_of(uint32_t v) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat162*>(&v)->x);
}
__device__ __forceinline__ float hi_of(uint32_t v) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat162*>(&v)->y);
}

// ---- the weight gradients of one k-step (16 staged rows)
// The k-step's rows as this lane's B rows: 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9.
struct KRows {
  float s[4], v[3][4];
};
__device__ __forceinline__ KRows k_rows(const float* geo, int t4) {
  KRows kr;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(geo + (2 * t4 + (j & 1) + (j >> 1) * 8) * 8);
    kr.s[j] = a.x;
    kr.v[0][j] = a.y;
    kr.v[1][j] = a.z;
    kr.v[2][j] = a.w;
  }
  return kr;
}

// dY columns 0..63 of the k-step as B fragments: [s d_o0 hi | lo] for the
// six O0 n-tiles, d_a raw for the two OA n-tiles
struct BScal {
  uint32_t hi[6][2], lo[6][2], a[2][2];
};
__device__ __forceinline__ void b_scaled(BScal& b, const bf16* Y, int row0, const KRows& kr,
                                         int lane) {
  const bf16* p = Y + (row0 + (lane & 15)) * kLdY + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < 3; ++np) {
    uint32_t r[4];
    ldsm_x4_t(r, p + kY0 + np * 16);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      split2(r[2 * j], kr.s[0], kr.s[1], b.hi[2 * np + j][0], b.lo[2 * np + j][0]);
      split2(r[2 * j + 1], kr.s[2], kr.s[3], b.hi[2 * np + j][1], b.lo[2 * np + j][1]);
    }
  }
  uint32_t r[4];
  ldsm_x4_t(r, p + kYa);
  b.a[0][0] = r[0]; b.a[0][1] = r[1]; b.a[1][0] = r[2]; b.a[1][1] = r[3];
}

// X^T A fragment of an m-tile: 16 features from column col of the k-step's
// rows (rows addressed per lane: row(lane's row) -> pointer)
__device__ __forceinline__ int a_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int a_col(int lane) { return ((lane >> 3) & 1) * 8; }

// the S group: acc[8] += X^T [s d_o0 | d_a]
__device__ __forceinline__ void wg_s(float (*acc)[4], const uint32_t (&a)[4], const BScal& b) {
#pragma unroll
  for (int nt = 0; nt < 6; ++nt) {
    mma_bf16_16816(acc[nt], a, b.hi[nt][0], b.hi[nt][1]);
    mma_bf16_16816(acc[nt], a, b.lo[nt][0], b.lo[nt][1]);
  }
  mma_bf16_16816(acc[6], a, b.a[0][0], b.a[0][1]);
  mma_bf16_16816(acc[7], a, b.a[1][0], b.a[1][1]);
}

// the V tile of component c and n-tile nt: acc += xv_c^T (s d_o1_c), from
// the staged d_o1_c columns
__device__ __forceinline__ void wg_v(float (&acc)[4], const uint32_t (&a)[4], const bf16* Y,
                                     int row0, int c, int nt, const KRows& kr, int lane) {
  uint32_t b0, b1, h0, h1, l0, l1;
  ldsm_x2_t(b0, b1, Y + (row0 + (lane & 15)) * kLdY + kY1 + kHV * c + 8 * nt);
  split2(b0, kr.s[0], kr.s[1], h0, l0);
  split2(b1, kr.s[2], kr.s[3], h1, l1);
  mma_bf16_16816(acc, a, h0, h1);
  mma_bf16_16816(acc, a, l0, l1);
}

// the dot lanes (sum_c xv_c v_c, fp32) of the three component fragments x
// of a k-step, split into three bf16 parts (A fragments)
__device__ __forceinline__ void dot_parts(uint32_t (&ap)[3][4], const uint32_t (&x)[3][4],
                                          const KRows& kr) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // register j holds rows (j < 2 ? 2 t4 : 2 t4 + 8) and + 1
    float d[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int rr = (j >> 1) * 2 + e;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) s = fmaf(e ? hi_of(x[c][j]) : lo_of(x[c][j]), kr.v[c][rr], s);
      d[e] = s;
    }
    const float h0 = rnd(d[0]), h1 = rnd(d[1]);
    const float m0 = rnd(d[0] - h0), m1 = rnd(d[1] - h1);
    ap[0][j] = pack(h0, h1);
    ap[1][j] = pack(m0, m1);
    ap[2][j] = pack(d[0] - h0 - m0, d[1] - h1 - m1);
  }
}

// the D tiles of n-tiles N0 .. N0+NN: acc[j] += dot^T d_o0, the dot of the
// three component fragments split into three bf16 parts
template <int N0, int NN>
__device__ __forceinline__ void wg_d(float (*acc)[4], const uint32_t (&x)[3][4], const bf16* Y,
                                     int row0, const KRows& kr, int lane) {
  uint32_t ap[3][4];
  dot_parts(ap, x, kr);
  const bf16* p = Y + (row0 + (lane & 15)) * kLdY + kY0;
#pragma unroll
  for (int j = 0; j < NN; ++j) {
    uint32_t b0, b1;
    ldsm_x2_t(b0, b1, p + (N0 + j) * 8);
#pragma unroll
    for (int pt = 0; pt < 3; ++pt) mma_bf16_16816(acc[j], ap[pt], b0, b1);
  }
}

// The table sum of a tile: dhu_t[i] = the sum of its bucket's scratch rows
// dhs[PERM[START[i] .. START[i+1])] in slot order, fp32, rounded once.  V
// bf16 columns a lane (V = 8 or 4: 16- or 8-byte loads, f / V lanes a row,
// 32 V / f rows a warp at once), or V = 1: a warp per row, a lane per
// column.  A bucket's rows are fetched kBatch at a time before their adds.
template <int V>
__device__ __forceinline__ void table_rows(const bf16* dhs, bf16* dhu_t, const int* PERM,
                                           const int* START, int u, int f, int warp, int lane,
                                           int nwarps = kWarps) {
  constexpr int kBatch = 8;
  typedef typename std::conditional<V == 8, uint4, typename std::conditional<V == 4, uint2,
                                    unsigned short>::type>::type Word;
  union Bits {
    Word w;
    unsigned short h[V];
  };
  const int per = V == 1 ? 1 : 32 / (f / V);  // rows a warp at once
  const int lanes = V == 1 ? 32 : f / V;      // lanes a row
  const int r = lane / lanes;
  for (int i0 = warp * per; i0 < u; i0 += nwarps * per) {
    const int i = i0 + r;
    const bool on = r < per && i < u;
    const int q0 = on ? START[i] : 0, q1 = on ? START[i + 1] : 0;
    for (int c = (lane % lanes) * V; c < (V == 1 ? f : (lane % lanes) * V + 1); c += 32 * V) {
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      for (int qb = q0; qb < q1; qb += kBatch) {
        Bits w[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (qb + j < q1) w[j].w = *reinterpret_cast<const Word*>(dhs + (long)PERM[qb + j] * f + c);
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (qb + j >= q1) break;
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] += bf(__ushort_as_bfloat16(w[j].h[e]));
        }
      }
      if (on) {
        Bits o;
#pragma unroll
        for (int e = 0; e < V; ++e) o.h[e] = __bfloat16_as_ushort(__float2bfloat16(acc[e]));
        *reinterpret_cast<Word*>(dhu_t + (long)i * f + c) = o.w;
      }
    }
  }
}

// The table sum of a gather tile (TAB, after the block's rounds): d_hu_t[i]
// = the sum of the d_hs scratch rows of the tile's slots with loc == i, in
// slot order.  A counting sort of loc into PERM (each bucket then sorted by
// slot), then table_rows: a table row per f / V lanes, V = 8 (16-byte loads)
// or 4 columns a lane (32 V / f rows a warp at once), else a warp per row and
// a lane per column; a bucket's rows are fetched kBatch at a time before
// their adds, which run in slot order.
__device__ void table_sum(const int* tloc, const bf16* dhs, bf16* dhu_t, int* PERM, int* START,
                          int* CUR, int slots, int u, int f, int warp, int lane, int nwarps) {
  for (int i = threadIdx.x; i < u; i += blockDim.x) CUR[i] = 0;
  __syncthreads();
  for (int sl = threadIdx.x; sl < slots; sl += blockDim.x) {
    const int l = tloc[sl];
    if (l < u) atomicAdd(&CUR[l], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int i = 0; i < u; ++i) {
      START[i] = run;
      run += CUR[i];
      CUR[i] = 0;
    }
    START[u] = run;
  }
  __syncthreads();
  for (int sl = threadIdx.x; sl < slots; sl += blockDim.x) {
    const int l = tloc[sl];
    if (l < u) PERM[START[l] + atomicAdd(&CUR[l], 1)] = sl;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < u; i += blockDim.x) {  // each bucket in slot order
    for (int q = START[i] + 1; q < START[i + 1]; ++q) {
      const int x = PERM[q];
      int y = q - 1;
      while (y >= START[i] && PERM[y] > x) {
        PERM[y + 1] = PERM[y];
        --y;
      }
      PERM[y + 1] = x;
    }
  }
  __syncthreads();
  if (f % 8 == 0 && f <= 256) table_rows<8>(dhs, dhu_t, PERM, START, u, f, warp, lane, nwarps);
  else if (f % 4 == 0 && f <= 128) table_rows<4>(dhs, dhu_t, PERM, START, u, f, warp, lane, nwarps);
  else table_rows<1>(dhs, dhu_t, PERM, START, u, f, warp, lane, nwarps);
  __syncthreads();
}

// Kernel arguments beyond the gather's
struct BwdArgs {
  bf16* dhu;       // TAB: [ntiles*U, F]
  bf16* dhr;       // [N, F]
  bf16* scratch;   // TAB: [grid][tile*K][F]
  bf16* dhsp;      // KM: [K, N, F]; FLAT: [N*K, F]
  float* partials; // [grid][NW]
  float* wacc;     // Wide: the weight-gradient accumulators [grid][jobs * 1024]
  int pack;
};

template <Addr A>
__global__ void __launch_bounds__(kThreads)
fused_message_bwd_mma(GatherArgs ga, const bf16* __restrict__ w0a, const bf16* __restrict__ w1sa,
                      const bf16* __restrict__ w1va, const bf16* __restrict__ w0b,
                      const bf16* __restrict__ w1sb, const bf16* __restrict__ w1vb,
                      BwdArgs ba) {
  constexpr bool TAB = A == Addr::kTab, KM = A == Addr::kKm, FLAT = A == Addr::kFlat;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k = ga.k, hs = ga.hs, hv = ga.hv, f = hs + 3 * hv;
  const int tile = ga.tile, u = ga.u, npad = ga.npad;
  unsigned char* p = smem_raw;
  bf16* W = reinterpret_cast<bf16*>(p);
  float* d2w = reinterpret_cast<float*>(p + align16(2L * kWRows * kLdW));
  p += weight_bytes();
  const long bb = buf_bytes(k, true), wb = warp_bytes(k);
  unsigned char* wbase = p;  // warp w's buffers at wbase + w * wb
  p += kWarps * wb;
  float* d2acc = reinterpret_cast<float*>(p);  // [kWarps][kN]
  p += align16(4L * kWarps * kN);
  bf16* X2 = reinterpret_cast<bf16*>(p);       // [kRound][kLdF]: m0 | m1_0 | m1_1 | m1_2
  bf16* Y2 = reinterpret_cast<bf16*>(p + align16(2L * kRound * kLdF));  // [kRound][kLdY]
  bf16* Y1 = Y2 + align16(2L * kRound * kLdY) / 2;
  int* PERM = reinterpret_cast<int*>(p);       // TAB, after a tile's rounds
  int* START = PERM + tile * k;
  int* CUR = START + u + 1;
  unsigned char* wp = wbase + warp * wb;
  bf16* kbuf = reinterpret_cast<bf16*>(wp + 2 * bb);  // [16][kLdK]: receiver parts of d_xs/d_xv

  for (long x = lane; x < 2 * bb / 16; x += 32)
    reinterpret_cast<uint4*>(wp)[x] = make_uint4(0u, 0u, 0u, 0u);
  for (int x = lane; x < kN; x += 32) d2acc[warp * kN + x] = 0.f;
  stage_weights<false>(l1mma::Bench(), W, d2w, w0a, w1sa, w1va, w0b, w1sb, w1vb, hs, hv);
  __syncthreads();

  // the block's items: gather tiles (TAB), or groups of kWarps units; R
  // rounds each, the unit of warp w at round rr: unit (rr / T) * kWarps + w
  // of the item, its tile rr % T
  const int G = unit_recv(k, TAB ? tile : 0), T = unit_tiles(k, TAB ? tile : 0);
  // (npad K < 2^31, checked by the wrapper: int arithmetic throughout)
  const int units = TAB ? (tile + G - 1) / G : (npad + G - 1) / G;
  const int items = TAB ? npad / tile : (units + kWarps - 1) / kWarps;
  const int R = TAB ? (units + kWarps - 1) / kWarps * T : T;
  const int my_items =
      (int)blockIdx.x < items ? (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x : 0;
  const int nit = my_items * R;
  auto item_of = [&](int it) { return (int)blockIdx.x + it / R * (int)gridDim.x; };
  auto ref = [&](int it, int w) {
    const int item = item_of(it), rr = it % R;
    TileRef tr;
    tr.q0 = rr % T * 16;
    if (TAB) {
      const int un = rr / T * kWarps + w;
      tr.node0 = item * tile + un * G;
      tr.nrecv = un < units ? (tile - un * G < G ? tile - un * G : G) : 0;
      tr.slot0 = (item * tile + un * G) * k;  // (npad K < 2^31)
    } else {
      const int un = item * kWarps + w;
      tr.node0 = un * G;
      tr.nrecv = un < units ? (npad - tr.node0 < G ? npad - tr.node0 : G) : 0;
      tr.slot0 = 0;
    }
    return tr;
  };
  const bool pairs = ga.mode != kCopy2;  // even widths: bf16 pairs of d_hs at once
  KSum ks;
  ksum_init(ks);
  float wacc[kTiles][4];
  zero(wacc);

  if (nit > 0) {
    gather_tile<A>(carve_buf(wp, k, true), ref(0, warp), ga, lane);
    cp_async_commit();
  }
#ifdef LMAX1_BWD_CLOCKS
  long long clock_t0 = clock64();
#endif
  for (int it = 0; it < nit; ++it) {
    if (it + 1 < nit) {
      gather_tile<A>(carve_buf(wp + ((it + 1) & 1) * bb, k, true), ref(it + 1, warp), ga, lane);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
#ifdef LMAX1_BWD_CLOCKS
    if (threadIdx.x == 0) atomicAdd(&bwd_phase_cycles[11], 1ull);
#endif
    BWD_CLOCK(0);  // the next tile's gather issued, this one's awaited
    const Buf b = carve_buf(wp + (it & 1) * bb, k, true);
    const TileRef tr = ref(it, warp);
    const RowGeo rg = row_geo(b.geo, g);
    const int wr = warp * 16;  // this warp's rows in the round's staging
    // ---- layer 1 (its residuals are recomputed for its VJP below: held
    //      through layer 2 beside the weight-gradient accumulators, they
    //      would spill)
    uint32_t am0[2][4], am1[3][4];
    {
      float o0[6][4], oa[2][4], ob[3][2][4];
      layer1(W, d2w, b, rg, kCG, lane, o0, oa, ob);
      gate1<false>(o0, oa, ob, rg, am0, am1);
    }
    store_a(X2, kLdF, wr, 0, am0[0], lane);
    store_a(X2, kLdF, wr, 16, am0[1], lane);
#pragma unroll
    for (int c = 0; c < 3; ++c) store_a(X2, kLdF, wr, kHS + kHV * c, am1[c], lane);
    BWD_CLOCK(1);  // layer 1, its gate, the staged layer-2 inputs
    // ---- layer 2 and the VJP of its gates, d_m = d_agg * mask (rounded)
    {
      float o0b[6][4], oab[2][4], obb[3][2][4];
      layer2(W, rg, kCG, lane, am0, am1, o0b, oab, obb);
      // d_m = d_agg of the row's receiver times its mask, rounded
      const bf16* dr0 = b.d + b.ri[g] * kLdF;
      const bf16* dr1 = b.d + b.ri[g + 8] * kLdF;
      gate_vjp(o0b, oab, obb,
               [&](int pc, int h) { return rnd(bf((h ? dr1 : dr0)[pc]) * rg.mk(h)); }, rg, Y2,
               wr, lane);
    }
    __syncwarp();
    // the staged cotangents as A fragments: row wr + (lane & 15), column col
    auto a_frag = [&](uint32_t (&a)[4], const bf16* Y, int col) {
      ldsm_x4(a, Y + (wr + (lane & 15)) * kLdY + (lane >> 4) * 8 + col);
    };
    BWD_CLOCK(2);  // layer 2 and its gates' VJP
    // ---- layer-2 input cotangents -> the layer-1 d_m0, d_m1 (bf16 values),
    //      kept in the K-sum buffer until the layer-1 VJP reads them
    // (an n-tile pair of the layer's input rows at a time: d_f0 = d_o0 W0^T
    // over three k-steps, d_xs = d_a W1S^T, d_xvs_c = d_o1_c W1V^T)
#pragma unroll
    for (int np = 0; np < 3; ++np) {
      float df[2][4];
      zero(df);
#pragma unroll
      for (int ks = 0; ks < 3; ++ks) {
        uint32_t a[4];
        a_frag(a, Y2, kY0 + 16 * ks);
        mma_pairT(df, a, W, kW2s + 16 * np, 16 * ks, lane);
      }
      if (np < 2) {  // the m0 rows
        float dx[2][4];
        zero(dx);
        uint32_t a[4];
        a_frag(a, Y2, kYa);
        mma_pairT(dx, a, W, kW2s + 16 * np, kC0, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float s = rg.s(h);
            const float x0 = rnd(dx[j][2 * h] + rnd(df[j][2 * h]) * s);
            const float x1 = rnd(dx[j][2 * h + 1] + rnd(df[j][2 * h + 1]) * s);
            *reinterpret_cast<__nv_bfloat162*>(kbuf + (g + 8 * h) * kLdK + (2 * np + j) * 8 +
                                               2 * t4) = __floats2bfloat162_rn(x0, x1);
          }
      } else {  // the dot rows
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float dv[2][4];
          zero(dv);
          uint32_t a[4];
          a_frag(a, Y2, kY1 + kHV * c);
          mma_pairT(dv, a, W, kW2v, kC0, lane);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float s = rg.s(h), v = rg.v(h, c);
              const float x0 = rnd(rnd(kCG * dv[i][2 * h]) * s + kCG * rnd(df[i][2 * h]) * v);
              const float x1 =
                  rnd(rnd(kCG * dv[i][2 * h + 1]) * s + kCG * rnd(df[i][2 * h + 1]) * v);
              *reinterpret_cast<__nv_bfloat162*>(kbuf + (g + 8 * h) * kLdK + kHS + kHV * c +
                                                 8 * i + 2 * t4) = __floats2bfloat162_rn(x0, x1);
            }
        }
      }
    }
    BWD_CLOCK(3);  // layer 2's input cotangents
    // ---- the VJP of the layer-1 gates, on layer 1 recomputed (o0, A, B)
    {
      float o0a[6][4], oaa[2][4], oba[3][2][4];
      layer1(W, d2w, b, rg, kCG, lane, o0a, oaa, oba);
      __syncwarp();
      gate_vjp(o0a, oaa, oba,
               [&](int pc, int h) { return bf(kbuf[(g + 8 * h) * kLdK + pc]); }, rg, Y1, wr,
               lane);
    }
    __syncwarp();  // Y1's rows are read across lanes, the K-sum buffer written again
    // the d2 rows of dW0a (d2 s d_o0) and dW1Sa (d2 d_a): this lane's rows,
    // then the warp's rows (lanes g = 0 hold the sums of their columns)
    {
      float pw[16];
      const float ds0 = rg.d2(0) * rg.s(0), ds1 = rg.d2(1) * rg.s(1);
      const bf16* y0 = Y1 + (wr + g) * kLdY + 2 * t4;
      const bf16* y1 = y0 + 8 * kLdY;
#pragma unroll
      for (int blk = 0; blk < 8; ++blk) {  // columns blk*8 + 2 t4 (+1): d_o0, then d_a
        const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(y0 + blk * 8));
        const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(y1 + blk * 8));
        const float f0 = blk < 6 ? ds0 : rg.d2(0), f1 = blk < 6 ? ds1 : rg.d2(1);
        pw[2 * blk] = fmaf(f1, x1.x, f0 * x0.x);
        pw[2 * blk + 1] = fmaf(f1, x1.y, f0 * x0.y);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        pw[j] += __shfl_xor_sync(0xffffffffu, pw[j], 4);
        pw[j] += __shfl_xor_sync(0xffffffffu, pw[j], 8);
        pw[j] += __shfl_xor_sync(0xffffffffu, pw[j], 16);
      }
      if (g == 0) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int blk = j >> 1, e = j & 1;  // blk: 16-column half-steps 0..7
          d2acc[warp * kN + blk * 8 + 2 * t4 + e] += pw[j];
        }
      }
    }
    BWD_CLOCK(4);  // layer 1 again, its gates' VJP, the d2 rows
    // ---- layer-1 input cotangents: sender parts -> d_hs, receiver parts
    //      -> the K-sum buffer
    const int qa = tr.q0 + g, qb = qa + 8;
    const int live = tr.nrecv * k;
    auto dhs_row = [&](int q) -> bf16* {
      if (q >= live) return nullptr;
      const int rel = q / k, kk = q % k;
      const long node = tr.node0 + rel;
      if (TAB) return ba.scratch + ((long)tr.slot0 + q) * f;
      if (KM) return ba.dhsp + ((long)kk * npad + node) * f;
      return ba.dhsp + (node * k + kk) * f;
    };
    bf16* hrow[2] = {dhs_row(qa), dhs_row(qb)};
    auto put = [&](int h, int pc, float x0, float x1) {
      bf16* row = hrow[h];
      if (row == nullptr) return;
      const int fc = l1mma::feat_col(l1mma::Bench(), pc, hs, hv);
      if (fc < 0) return;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(row + fc) = __floats2bfloat162_rn(x0, x1);
      } else {
        row[fc] = __float2bfloat16(x0);
        const int fc1 = l1mma::feat_col(l1mma::Bench(), pc + 1, hs, hv);
        if (fc1 >= 0) row[fc1] = __float2bfloat16(x1);
      }
    };
    auto put_k = [&](int h, int pc, float x0, float x1) {
      *reinterpret_cast<__nv_bfloat162*>(kbuf + (g + 8 * h) * kLdK + pc) =
          __floats2bfloat162_rn(x0, x1);
    };
    // the scalar rows (sender 0..31, receiver 32..63), an n-tile pair at a time
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      float df[2][4], dx[2][4];
      zero(df);
      zero(dx);
#pragma unroll
      for (int ks = 0; ks < 3; ++ks) {
        uint32_t a[4];
        a_frag(a, Y1, kY0 + 16 * ks);
        mma_pairT(df, a, W, kW1s + 16 * np, 16 * ks, lane);
      }
      uint32_t a[4];
      a_frag(a, Y1, kYa);
      mma_pairT(dx, a, W, kW1s + 16 * np, kC0, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float s = rg.s(h);
          const float x0 = rnd(dx[j][2 * h] + rnd(df[j][2 * h]) * s);
          const float x1 = rnd(dx[j][2 * h + 1] + rnd(df[j][2 * h + 1]) * s);
          const int pc = ((2 * np + j) & 3) * 8 + 2 * t4;
          if (np < 2) put(h, pc, x0, x1);
          else put_k(h, pc, x0, x1);
        }
    }
    // the vector lanes (sender 0..15, receiver 16..31)
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      float df[2][4];
      zero(df);
#pragma unroll
      for (int ks = 0; ks < 3; ++ks) {
        uint32_t a[4];
        a_frag(a, Y1, kY0 + 16 * ks);
        mma_pairT(df, a, W, kW1v + 16 * np, 16 * ks, lane);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float dx[2][4];
        zero(dx);
        uint32_t a[4];
        a_frag(a, Y1, kY1 + kHV * c);
        mma_pairT(dx, a, W, kW1v + 16 * np, kC0, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float s = rg.s(h), v = rg.v(h, c);
            const float x0 = rnd(rnd(kCG * dx[j][2 * h]) * s + kCG * rnd(df[j][2 * h]) * v);
            const float x1 =
                rnd(rnd(kCG * dx[j][2 * h + 1]) * s + kCG * rnd(df[j][2 * h + 1]) * v);
            const int pc = kHS + kHV * c + j * 8 + 2 * t4;
            if (np == 0) put(h, pc, x0, x1);
            else put_k(h, pc, x0, x1);
          }
      }
    }
    __syncwarp();
    BWD_CLOCK(5);  // layer 1's input cotangents, d_hs written
    ksum_tile<FLAT>(ks, kbuf, tr, k, ba.pack, hs, hv, ba.dhr, lane);
    BWD_CLOCK(6);  // the K-sum of d_hr

    // ---- the round's weight gradients
    __syncthreads();
    BWD_CLOCK(7);  // waiting for the other warps' tiles
    {
      // the roles (tiles of dW = X^T dY; S: scalar inputs against [s d_o0 |
      // d_a], V: vector inputs against s d_o1_c, D: the dot lanes against
      // d_o0): warps 0-3 the S tiles of layer 1's xs (sender 0-15, 16-31,
      // receiver 0-15, 16-31), 4-5 those of layer 2's m0 (0-15, 16-31), each
      // with one n-tile of a V group (layer 2's m1; layer 1's sender, then
      // receiver vector lanes); warps 6-7 the D tiles of layer 1's sender,
      // receiver dot lanes, each with three n-tiles of layer 2's
      const int ar = a_row(lane), ac = a_col(lane);
#pragma unroll 1
      for (int kw = 0; kw < kWarps; ++kw) {
        const Buf bk = carve_buf(wbase + kw * wb + (it & 1) * bb, k, true);
        const KRows kr = k_rows(bk.geo, t4);
        const int r0 = kw * 16;
        const bf16* xs_s = bk.s + ar * kLdF + ac;             // sender features
        const bf16* xs_r = bk.r + bk.ri[ar] * kLdF + ac;      // receiver features
        const bf16* x2 = X2 + (r0 + ar) * kLdF + ac;          // m0 | m1
        if (warp < 6) {
          const bool l1 = warp < 4;
          BScal bs;
          b_scaled(bs, l1 ? Y1 : Y2, r0, kr, lane);
          uint32_t a[4];
          ldsm_x4_t(a, (l1 ? ((warp & 2) ? xs_r : xs_s) : x2) + 16 * (warp & 1));
          wg_s(wacc, a, bs);
          // the V n-tile: warps 0-1 layer 2's m1, 2-3 layer 1's sender and
          // 4-5 its receiver vector lanes
          const bf16* xv = warp < 2 ? x2 : warp < 4 ? xs_s : xs_r;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            ldsm_x4_t(a, xv + kHS + kHV * c);
            wg_v(wacc[8], a, warp < 2 ? Y2 : Y1, r0, c, warp & 1, kr, lane);
          }
        } else {
          uint32_t x[3][4];
#pragma unroll
          for (int c = 0; c < 3; ++c) ldsm_x4_t(x[c], (warp == 6 ? xs_s : xs_r) + kHS + kHV * c);
          wg_d<0, 6>(wacc, x, Y1, r0, kr, lane);
#pragma unroll
          for (int c = 0; c < 3; ++c) ldsm_x4_t(x[c], x2 + kHS + kHV * c);
          if (warp == 6) wg_d<0, 3>(wacc + 6, x, Y2, r0, kr, lane);
          else wg_d<3, 3>(wacc + 6, x, Y2, r0, kr, lane);
        }
      }
    }
    BWD_CLOCK(8);  // warp 0's weight-gradient tiles over the round's rows
    __syncthreads();
    BWD_CLOCK(9);  // waiting for the other warps' weight gradients
  }

  // ---- this block's weight gradients, once: partials[block] in the six
  //      blocks' dense layout (W0a, W1Sa, W1Va, W0b, W1Sb, W1Vb)
  const int s1 = 2 * hs + 1, v1 = 2 * hv, c0 = hs + hv;
  float* out = ba.partials + (long)blockIdx.x * ((long)(s1 + v1) * c0 + (long)s1 * hv +
                                                 (long)v1 * hv + (long)c0 * c0 + (long)hs * hv +
                                                 (long)hv * hv);
  float* o_w0a = out;
  float* o_w1sa = o_w0a + (s1 + v1) * c0;
  float* o_w1va = o_w1sa + s1 * hv;
  float* o_w0b = o_w1va + v1 * hv;
  float* o_w1sb = o_w0b + c0 * c0;
  float* o_w1vb = o_w1sb + hs * hv;
  // an S group's tiles: rows i (-1: a pad) x [O0 columns -> w0 | OA -> w1]
  auto put_s = [&](const float (*acc)[4], int mt16, int rowbase, int nvalid, float* w0,
                   float* w1) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = mt16 + g + 8 * (q >> 1);
        if (m >= nvalid) continue;
        const int i = rowbase + m;
        int o, jj;
        l1mma::out_col(l1mma::Bench(), nt * 8 + 2 * t4 + (q & 1), hs, hv, o, jj);
        if (o >= 0) w0[i * c0 + o] = acc[nt][q];
        else if (jj >= 0) w1[i * hv + jj] = acc[nt][q];
      }
  };
  // D tiles, n-tiles n0 .. n0+nn of w0's dot rows (times CG110)
  auto put_d = [&](const float (*acc)[4], int n0, int nn, int rowbase, float* w0) {
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = g + 8 * (q >> 1);
        if (j >= nn || m >= hv) continue;
        int o, jj;
        l1mma::out_col(l1mma::Bench(), (n0 + j) * 8 + 2 * t4 + (q & 1), hs, hv, o, jj);
        if (o >= 0) w0[(rowbase + m) * c0 + o] = kCG * acc[j][q];
      }
  };
  // a V tile, n-tile nt of w1v's rows (times CG011)
  auto put_v = [&](const float (&acc)[4], int nt, int rowbase, float* w1) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = g + 8 * (q >> 1), jj = nt * 8 + 2 * t4 + (q & 1);
      if (m < hv && jj < hv) w1[(rowbase + m) * hv + jj] = kCG * acc[q];
    }
  };
  if (warp < 4) {  // layer 1's xs: sender scalars (warps 0-1), receiver (2-3)
    put_s(wacc, 16 * (warp & 1), (warp & 2) ? hs : 0, hs, o_w0a, o_w1sa);
  } else if (warp < 6) {  // layer 2's m0
    put_s(wacc, 16 * (warp & 1), 0, hs, o_w0b, o_w1sb);
  } else {  // the dot rows
    put_d(wacc, 0, 6, warp == 6 ? s1 : s1 + hv, o_w0a);
    put_d(wacc + 6, warp == 6 ? 0 : 3, 3, hs, o_w0b);
  }
  if (warp < 2) put_v(wacc[8], warp & 1, 0, o_w1vb);
  else if (warp < 6) put_v(wacc[8], warp & 1, warp < 4 ? 0 : hv, o_w1va);
  // the d2 rows: the warps' sums in warp order
  for (int col = threadIdx.x; col < kN; col += blockDim.x) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += d2acc[w * kN + col];
    int o, jj;
    l1mma::out_col(l1mma::Bench(), col, hs, hv, o, jj);
    if (o >= 0) o_w0a[2 * hs * c0 + o] = acc;
    else if (jj >= 0) o_w1sa[2 * hs * hv + jj] = acc;
  }
  if (!TAB) return;

  // ---- TAB, after every round (the weight-gradient accumulators are written
  //      and free: inside the rounds the table sum ran out of registers):
  //      each of the block's gather tiles' table rows, d_hu[u] = the sum of
  //      the d_hs scratch rows of the tile's slots with loc == u, in slot
  //      order
  __syncthreads();  // the staging region becomes the table sum's ints
  for (int j = 0; j < my_items; ++j) {
    const long tl = blockIdx.x + (long)j * gridDim.x;  // the gather tile
    table_sum(ga.loc + tl * tile * k, ba.scratch + tl * tile * k * f, ba.dhu + tl * u * f, PERM,
              START, CUR, tile * k, u, f, warp, lane, kWarps);
    BWD_CLOCK(10);  // the tile's table sum
  }
}

// ---------------------------------------------------------------------------
// bf16 past 32x0e+16x1o: the Wide kernel, instance M (lmax1_mma.cuh: "The
// Wide kernels").  The rounds, the per-warp tile work and its rounding are
// the Bench kernel's, a column block at a time, the weights of each block
// (and, for the input-cotangent products, each 16 input rows) through the
// block's ring; the layer-1 outputs pass to layer 2 in registers, and layer
// 2's input cotangents (layer 1's d_m) to layer 1's gate VJP in registers up
// to m = 2, past it through the K-sum buffer (BwdWide::kDmRegs).
// The weight gradients are too many tiles for registers (288 16x8 tiles at
// m = 2), so they are cut into jobs (an m-tile of one GEMM's dW = X^T dY
// against up to 8 n-tiles), and each job's accumulators live in the block's
// rows of global memory (wacc): a warp loads a job's 32 values a lane, adds
// the round's k-steps (the warps' rows, in warp order: the Bench kernel's
// order) and stores them back.  Layer 2's jobs run after its input
// cotangents, layer 1's after the K-sum, each between two block barriers, so
// the staging of layer 1's cotangents (Y1) reuses that of layer 2's inputs
// and cotangents (X2, Y2).  Each value is summed in a fixed order, so reruns
// are bit-identical.  A block holds as many warps as shared memory takes
// (at most kWarps; eight at m = 1, with the Bench kernel's rounds and grid,
// where every output is the Bench kernel's bit for bit).
using l1mma::ChunkLane; using l1mma::chunk_lane; using l1mma::KSumN; using l1mma::l1_sblk;
using l1mma::l1_vblk; using l1mma::l2_sblk; using l1mma::l2_vblk; using l1mma::layer1_wide;
using l1mma::mma_rc; using l1mma::wide_m; using l1mma::WidePack; using l1mma::WideS;
using l1mma::WRing;

template <Addr A, int M> struct BwdWide {
  typedef WRing<M, true> Ring;
  static constexpr int kHsp = 32 * M, kHvp = 16 * M, kC0 = 48 * M, kN = 64 * M;
  static constexpr int kLdF = 80 * M + 8, kLdK = 80 * M + 8;
  // the staged cotangent rows [d_o0 (c0) | d_a (hvp) | d_o1 (3 hvp)], and
  // where d_o1 starts
  static constexpr int kLdY = kC0 + 4 * kHvp + 8, kY1 = kC0 + kHvp;
  static constexpr int kCols = (80 * M + 31) / 32;  // the K-sum's columns a lane
  // Layer 1's d_m, from layer 2's input cotangents to layer 1's gate VJP:
  // in registers up to m = 2 (20 m a lane fit beside the rest), so that the
  // K-sum buffer can take the staging's tail once layer 2's jobs are done
  // (one warp more an SM at m = 2); past m = 2 both in a per-warp buffer
  static constexpr bool kDmRegs = M <= 2;
  // per warp: two gather buffers (with the d_agg rows), the K-sum buffer
  // (past m = 2), the d2 rows' sums [n] fp32
  __host__ __device__ static long warp_bytes(int k) {
    return 2 * buf_bytes(WideS<M>(), k, true) + (kDmRegs ? 0 : align16(2L * 16 * kLdK)) +
           4L * kN;
  }
  // the round's staging: X2 [rows][ldf], Y2 [rows][ldy] (Y1 [rows][ldy] at
  // its start)
  __host__ __device__ static long staging_bytes(int warps) {
    return align16(2L * 16 * warps * kLdF) + align16(2L * 16 * warps * kLdY);
  }
  __host__ __device__ static constexpr long fixed_bytes() {
    return (Ring::kBytes + 15) / 16 * 16 + 4L * kN;
  }
  // shared memory: the ring, d2w; the per-warp buffers; the staging (aliased
  // by the table sum's ints)
  __host__ __device__ static long smem_bytes(int k, int tile, int u, int warps) {
    const long st = staging_bytes(warps), csr = tile > 0 ? csr_bytes(k, tile, u) : 0;
    return fixed_bytes() + warps * warp_bytes(k) + (st > csr ? st : csr);
  }
  __host__ static int warps(int k, int tile, int u) {
    int w = kWarps;
    while (w > 0 && smem_bytes(k, tile, u, w) > gmma::kMaxSmem) --w;
    return w;
  }
};

// The gate VJP of one Wide column block (gate_vjp's arithmetic), d_m from
// dm(n-tile, e, h) (padded column 8 n-tile + 2 t4 + e of the lane's row g + 8
// h): a scalar block's d_o0 at staging columns 32 cb ..; a vector block's
// d_o0 (its gate columns), d_a and d_o1_c, into rows r0 .. r0+15 of Y [..][ld]
// ([d_o0 (c0) | d_a (hvp) | d_o1_0 | d_o1_1 | d_o1_2])
template <typename DM>
__device__ __forceinline__ void wvjp_s(const float (&o)[4][4], DM dm, bf16* Y, int ld, int r0,
                                       int cb, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    float x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float v = o[nt][q], sg = sigm(v);
      x[q] = dm(4 * cb + nt, q & 1, q >> 1) * (sg * (1.0f + v * (1.0f - sg)));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(Y + (r0 + g + 8 * h) * ld + 32 * cb + nt * 8 + 2 * t4) =
          __floats2bfloat162_rn(x[2 * h], x[2 * h + 1]);
  }
}
template <int M, typename DM>
__device__ __forceinline__ void wvjp_v(const float (&og)[2][4], const float (&oa)[2][4],
                                       const float (&ob)[3][2][4], DM dm, const RowGeo& rg,
                                       bf16* Y, int ld, int r0, int v, int lane) {
  constexpr int HSP = 32 * M, HVP = 16 * M, C0 = 48 * M;
  const int g = lane >> 2, t4 = lane & 3;
  auto put = [&](int h, int col, float x0, float x1) {
    *reinterpret_cast<__nv_bfloat162*>(Y + (r0 + g + 8 * h) * ld + col + 2 * t4) =
        __floats2bfloat162_rn(x0, x1);
  };
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float xg[4], xa[4], x1[3][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int h = q >> 1;
      const float gv = sigm(og[i][q]);
      float d_g = 0.f, d_a = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float d = dm((HSP + HVP * c + 16 * v) / 8 + i, q & 1, h);
        d_g = fmaf(d, kCG * fmaf(rg.v(h, c), oa[i][q], ob[c][i][q]), d_g);
        const float d_o1 = rnd(d * gv);
        x1[c][q] = d_o1;
        d_a = fmaf(d_o1, rg.v(h, c), d_a);
      }
      xg[q] = d_g * (gv * (1.0f - gv));
      xa[q] = kCG * d_a;
    }
    const int col = 16 * v + 8 * i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      put(h, HSP + col, xg[2 * h], xg[2 * h + 1]);
      put(h, C0 + col, xa[2 * h], xa[2 * h + 1]);
#pragma unroll
      for (int c = 0; c < 3; ++c) put(h, C0 + HVP * (1 + c) + col, x1[c][2 * h], x1[c][2 * h + 1]);
    }
  }
}

// The weight-gradient jobs, in this order: layer 1's S (scalar inputs x [s
// d_o0 | d_a]: 4 m m-tiles, sender then receiver), V (vector lanes x s
// d_o1_c: 2 m) and D (dot lanes x d_o0: 2 m), then layer 2's S (2 m: m0), V
// (m) and D (m).  Each m-tile's n-tiles in groups of 8.
struct Job {
  int kind, layer, mt, nt0, nn;  // kind 0 S, 1 V, 2 D
};
__host__ __device__ inline int n_groups(int ntiles) { return (ntiles + 7) / 8; }
template <int M> __host__ __device__ inline int wide_jobs(int layer) {
  const int ns = n_groups(8 * M), nv = n_groups(2 * M), nd = n_groups(6 * M);
  return layer == 1 ? 4 * M * ns + 2 * M * nv + 2 * M * nd : 2 * M * ns + M * nv + M * nd;
}
template <int M> __host__ __device__ inline long wide_wacc_floats() {
  return (wide_jobs<M>(1) + wide_jobs<M>(2)) * 1024L;
}
template <int M> __device__ inline Job job_of(int q) {
  const int mts[6] = {4 * M, 2 * M, 2 * M, 2 * M, M, M};
  const int nts[3] = {8 * M, 2 * M, 6 * M};
  Job jb;
  for (int seg = 0; seg < 6; ++seg) {
    const int kind = seg % 3, ng = n_groups(nts[kind]);
    if (q < mts[seg] * ng) {
      jb.kind = kind;
      jb.layer = 1 + seg / 3;
      jb.mt = q / ng;
      jb.nt0 = q % ng * 8;
      jb.nn = nts[kind] - jb.nt0 < 8 ? nts[kind] - jb.nt0 : 8;
      return jb;
    }
    q -= mts[seg] * ng;
  }
  jb.kind = -1;
  return jb;
}

// The round's weight-gradient jobs of one layer: jobs q0 .. q1, job q by warp
// (q - q0) % nwarps, each over the round's k-steps (the warps' rows, in warp
// order).  X: layer 1 the gather buffers' rows, layer 2 X2; Y: the layer's
// staged cotangents.
template <int M>
__device__ __noinline__ void wgrad_jobs(float* wacc, int q0, int q1, const unsigned char* wbase,
                                           long wb, long boff, int k, const bf16* X2,
                                           const bf16* Y, int warp, int nwarps, int lane) {
  typedef BwdWide<Addr::kTab, M> B;
  constexpr int HSP = B::kHsp, HVP = B::kHvp, C0 = B::kC0, LDF = B::kLdF, LDY = B::kLdY;
  const WideS<M> sh{};
  const int t4 = lane & 3;
  for (int q = q0 + warp; q < q1; q += nwarps) {
    const Job jb = job_of<M>(q);
    float acc[8][4];
    float4* slot = reinterpret_cast<float4*>(wacc + (long)q * 1024) + lane;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 x = slot[32 * j];
      acc[j][0] = x.x; acc[j][1] = x.y; acc[j][2] = x.z; acc[j][3] = x.w;
    }
#pragma unroll 1
    for (int kw = 0; kw < nwarps; ++kw) {
      const Buf bk = carve_buf(sh, const_cast<unsigned char*>(wbase) + kw * wb + boff, k, true);
      const KRows kr = k_rows(bk.geo, t4);
      const int r0 = kw * 16;
      const bf16* xs_s = bk.s + a_row(lane) * LDF + a_col(lane);         // sender features
      const bf16* xs_r = bk.r + bk.ri[a_row(lane)] * LDF + a_col(lane);  // receiver features
      const bf16* x2 = X2 + (r0 + a_row(lane)) * LDF + a_col(lane);      // m0 | m1
      const bf16* yrow = Y + (r0 + (lane & 15)) * LDY + (lane >> 4) * 8;
      // the job's vector rows of component c (V, D)
      auto xv = [&](int c) {
        const int off = HSP + HVP * c;
        if (jb.layer == 2) return x2 + off + 16 * jb.mt;
        return (jb.mt < M ? xs_s + 16 * jb.mt : xs_r + 16 * (jb.mt - M)) + off;
      };
      if (jb.kind == 0) {
        uint32_t a[4];
        const bf16* xrow = jb.layer == 2 ? x2 + 16 * jb.mt
                           : jb.mt < 2 * M ? xs_s + 16 * jb.mt
                                           : xs_r + 16 * (jb.mt - 2 * M);
        ldsm_x4_t(a, xrow);
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          if (2 * pp >= jb.nn) continue;
          const int nt = jb.nt0 + 2 * pp;
          uint32_t r[4];
          ldsm_x4_t(r, yrow + 8 * nt);
          if (8 * nt < C0) {  // s d_o0, split
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              uint32_t h0, l0, h1, l1;
              split2(r[2 * jj], kr.s[0], kr.s[1], h0, l0);
              split2(r[2 * jj + 1], kr.s[2], kr.s[3], h1, l1);
              mma_bf16_16816(acc[2 * pp + jj], a, h0, h1);
              mma_bf16_16816(acc[2 * pp + jj], a, l0, l1);
            }
          } else {  // d_a
            mma_bf16_16816(acc[2 * pp], a, r[0], r[1]);
            mma_bf16_16816(acc[2 * pp + 1], a, r[2], r[3]);
          }
        }
      } else if (jb.kind == 1) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          uint32_t a[4];
          ldsm_x4_t(a, xv(c));
#pragma unroll
          for (int pp = 0; pp < 4; ++pp) {
            if (2 * pp >= jb.nn) continue;
            uint32_t r[4];
            ldsm_x4_t(r, yrow + B::kY1 + HVP * c + 8 * (jb.nt0 + 2 * pp));
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              uint32_t h0, l0, h1, l1;
              split2(r[2 * jj], kr.s[0], kr.s[1], h0, l0);
              split2(r[2 * jj + 1], kr.s[2], kr.s[3], h1, l1);
              mma_bf16_16816(acc[2 * pp + jj], a, h0, h1);
              mma_bf16_16816(acc[2 * pp + jj], a, l0, l1);
            }
          }
        }
      } else {
        uint32_t x[3][4];
#pragma unroll
        for (int c = 0; c < 3; ++c) ldsm_x4_t(x[c], xv(c));
        uint32_t ap[3][4];
        dot_parts(ap, x, kr);
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          if (2 * pp >= jb.nn) continue;
          uint32_t r[4];
          ldsm_x4_t(r, yrow + 8 * (jb.nt0 + 2 * pp));
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int pt = 0; pt < 3; ++pt)
              mma_bf16_16816(acc[2 * pp + jj], ap[pt], r[2 * jj], r[2 * jj + 1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) slot[32 * j] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
}

template <Addr A, int M>
__global__ void __launch_bounds__(kThreads, 1)
fused_message_bwd_wide_mma(GatherArgs ga, const unsigned char* __restrict__ wpk, BwdArgs ba) {
  constexpr bool TAB = A == Addr::kTab, KM = A == Addr::kKm, FLAT = A == Addr::kFlat;
  typedef BwdWide<A, M> B;
  typedef typename B::Ring Ring;
  constexpr int HSP = B::kHsp, HVP = B::kHvp, C0 = B::kC0, NP = B::kN;
  constexpr int LDF = B::kLdF, LDK = B::kLdK, LY = B::kLdY, YV = B::kY1;
  constexpr int PER = Ring::kPerTile;
  const WideS<M> sh{};
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int k = ga.k, hs = ga.hs, hv = ga.hv, f = hs + 3 * hv;
  const int tile = ga.tile, u = ga.u, npad = ga.npad;
  float* d2w = reinterpret_cast<float*>(smem_raw + (Ring::kBytes + 15) / 16 * 16);
  const long bb = buf_bytes(sh, k, true), wb = B::warp_bytes(k);
  unsigned char* wbase = smem_raw + B::fixed_bytes();  // warp w's buffers at wbase + w * wb
  unsigned char* wp = wbase + warp * wb;
  const long d2off = 2 * bb + (B::kDmRegs ? 0 : align16(2L * 16 * LDK));
  float* d2acc = reinterpret_cast<float*>(wp + d2off);  // [n]
  unsigned char* p = wbase + nwarps * wb;
  const int rows = 16 * nwarps;
  // [16][ldk]: layer 1's d_m (past m = 2), then the receiver parts of its
  // input cotangents (up to m = 2 in the staging's tail, past Y1)
  bf16* kbuf = B::kDmRegs
      ? reinterpret_cast<bf16*>(p + align16(2L * rows * LY)) + warp * 16 * LDK
      : reinterpret_cast<bf16*>(wp + 2 * bb);
  bf16* X2 = reinterpret_cast<bf16*>(p);  // [rows][ldf]: m0 | m1_0 | m1_1 | m1_2
  bf16* Y2 = reinterpret_cast<bf16*>(p + align16(2L * rows * LDF));  // [rows][ldy]
  bf16* Y1 = X2;  // [rows][ldy], after layer 2's weight gradients
  int* PERM = reinterpret_cast<int*>(p);  // TAB, after a tile's rounds
  int* START = PERM + tile * k;
  int* CUR = START + u + 1;
  const int nj1 = wide_jobs<M>(1), njobs = nj1 + wide_jobs<M>(2);
  float* wacc = ba.wacc + (long)blockIdx.x * wide_wacc_floats<M>();

  for (long x = lane; x < 2 * bb / 16; x += 32)
    reinterpret_cast<uint4*>(wp)[x] = make_uint4(0u, 0u, 0u, 0u);
  for (int x = lane; x < NP; x += 32) d2acc[x] = 0.f;
  for (int q = warp; q < njobs; q += nwarps)
    for (int x = lane; x < 256; x += 32)
      reinterpret_cast<float4*>(wacc + (long)q * 1024)[x] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = threadIdx.x; c < NP; c += blockDim.x)
    d2w[c] = reinterpret_cast<const float*>(wpk + WidePack<M>::D2W_OFF)[c];

  // the block's items and rounds: as the Bench kernel's, nwarps units a round
  const int G = unit_recv(k, TAB ? tile : 0), T = unit_tiles(k, TAB ? tile : 0);
  const int units = TAB ? (tile + G - 1) / G : (npad + G - 1) / G;
  const int items = TAB ? npad / tile : (units + nwarps - 1) / nwarps;
  const int R = TAB ? (units + nwarps - 1) / nwarps * T : T;
  const int my_items =
      (int)blockIdx.x < items ? (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x : 0;
  const int nit = my_items * R;
  Ring ring;
  ring.setup(smem_raw, wpk, nit * PER, nwarps);
  ring.start();  // (its block barrier also orders d2w, the buffers and wacc)
  auto item_of = [&](int it) { return (int)blockIdx.x + it / R * (int)gridDim.x; };
  auto ref = [&](int it, int w) {
    const int item = item_of(it), rr = it % R;
    TileRef tr;
    tr.q0 = rr % T * 16;
    if (TAB) {
      const int un = rr / T * nwarps + w;
      tr.node0 = item * tile + un * G;
      tr.nrecv = un < units ? (tile - un * G < G ? tile - un * G : G) : 0;
      tr.slot0 = (item * tile + un * G) * k;  // (npad K < 2^31)
    } else {
      const int un = item * nwarps + w;
      tr.node0 = un * G;
      tr.nrecv = un < units ? (npad - tr.node0 < G ? npad - tr.node0 : G) : 0;
      tr.slot0 = 0;
    }
    return tr;
  };
  const bool pairs = ga.mode != kCopy2;  // even widths: bf16 pairs of d_hs at once
  KSumN<B::kCols> ks;
  ksum_init(ks);
  const int ar = lane & 15, ac = (lane >> 4) * 8;
  const ChunkLane cl = chunk_lane(lane);

  if (nit > 0) {
    gather_tile<A>(carve_buf(sh, wp, k, true), ref(0, warp), ga, lane, sh);
    cp_async_commit();
  }
#ifdef LMAX1_BWD_CLOCKS
  long long clock_t0 = clock64();
#endif
  for (int it = 0; it < nit; ++it) {
    if (it + 1 < nit) {
      gather_tile<A>(carve_buf(sh, wp + ((it + 1) & 1) * bb, k, true), ref(it + 1, warp), ga,
                     lane, sh);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
#ifdef LMAX1_BWD_CLOCKS
    if (threadIdx.x == 0) atomicAdd(&bwd_phase_cycles[11], 1ull);
#endif
    BWD_CLOCK(0);  // the next tile's gather issued, this one's awaited
    const Buf b = carve_buf(sh, wp + (it & 1) * bb, k, true);
    const TileRef tr = ref(it, warp);
    const RowGeo rg = row_geo(b.geo, g);
    const int wr = warp * 16;  // this warp's rows in the round's staging
    const int q = it * PER;    // the tile's first chunk
    const bf16* xs = b.s + ar * LDF + ac;
    const bf16* xr = b.r + b.ri[ar] * LDF + ac;
    {
      // ---- layer 1 and its gates: layer 2's A fragments, staged in X2 for
      //      its weight gradients
      uint32_t am0[2 * M][4], am1[M][3][4];
      layer1_wide<M, false>(ring, q, lane, cl, xs, xr, d2w, rg, kCG, am0, am1);
#pragma unroll
      for (int ks2 = 0; ks2 < 2 * M; ++ks2) store_a(X2, LDF, wr, 16 * ks2, am0[ks2], lane);
#pragma unroll
      for (int v = 0; v < M; ++v)
#pragma unroll
        for (int c = 0; c < 3; ++c) store_a(X2, LDF, wr, HSP + HVP * c + 16 * v, am1[v][c], lane);
      BWD_CLOCK(1);  // layer 1, its gates, the staged layer-2 inputs
      // ---- layer 2 and the VJP of its gates, d_m = d_agg * mask (rounded)
      const bf16* dr0 = b.d + b.ri[g] * LDF;
      const bf16* dr1 = b.d + b.ri[g + 8] * LDF;
      auto dm = [&](int nt, int e, int h) {
        return rnd(bf((h ? dr1 : dr0)[nt * 8 + 2 * t4 + e]) * rg.mk(h));
      };
#pragma unroll
      for (int cb = 0; cb < M; ++cb) {
        float o[4][4];
        l2_sblk<M>(ring, q + 4 * M + cb, lane, cl, am0, am1, rg, kCG, o);
        wvjp_s(o, dm, Y2, LY, wr, cb, lane);
      }
#pragma unroll
      for (int v = 0; v < M; ++v) {
        float og[2][4], oa[2][4], ob[3][2][4];
        l2_vblk<M>(ring, q + 5 * M + v, lane, cl, am0, am1, rg, kCG, v, og, oa, ob);
        wvjp_v<M>(og, oa, ob, dm, rg, Y2, LY, wr, v, lane);
      }
    }
    __syncwarp();
    BWD_CLOCK(2);  // layer 2 and its gates' VJP
    auto a_frag = [&](uint32_t (&a)[4], const bf16* Y, int col) {
      ldsm_x4(a, Y + (wr + ar) * LY + ac + col);
    };
    // ---- layer 2's input cotangents (its row chunks: m0 rows, then m1) ->
    //      layer 1's d_m0, d_m1 (bf16 values), kept until the layer-1 VJP
    //      reads them: n-tile nt of the padded feature columns, row g + 8 h
    uint32_t dmr[B::kDmRegs ? 10 * M : 1][2];
    auto put_dm = [&](int nt, int h, float x0, float x1) {
      if constexpr (B::kDmRegs)
        dmr[nt][h] = l1mma::pack(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(kbuf + (g + 8 * h) * LDK + nt * 8 + 2 * t4) =
            __floats2bfloat162_rn(x0, x1);
    };
    auto l2_cotangents = [&](int pr) {
      const bf16* ch = ring.acquire(q + 6 * M + pr);
      float df[2][4];
      zero(df);
#pragma unroll
      for (int kx = 0; kx < 3 * M; ++kx) {
        uint32_t a[4];
        a_frag(a, Y2, 16 * kx);
        mma_rc(df, a, ch, 16 * kx, cl);
      }
      if (pr < 2 * M) {  // the m0 rows
        float dx[2][4];
        zero(dx);
#pragma unroll
        for (int kx = 0; kx < M; ++kx) {
          uint32_t a[4];
          a_frag(a, Y2, C0 + 16 * kx);
          mma_rc(dx, a, ch, C0 + 16 * kx, cl);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float s = rg.s(h);
            const float x0 = rnd(dx[j][2 * h] + rnd(df[j][2 * h]) * s);
            const float x1 = rnd(dx[j][2 * h + 1] + rnd(df[j][2 * h + 1]) * s);
            put_dm(2 * pr + j, h, x0, x1);
          }
      } else {  // the m1 rows
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float dv[2][4];
          zero(dv);
#pragma unroll
          for (int kx = 0; kx < M; ++kx) {
            uint32_t a[4];
            a_frag(a, Y2, YV + HVP * c + 16 * kx);
            mma_rc(dv, a, ch, C0 + 16 * kx, cl);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float s = rg.s(h), v = rg.v(h, c);
              const float x0 = rnd(rnd(kCG * dv[i][2 * h]) * s + kCG * rnd(df[i][2 * h]) * v);
              const float x1 =
                  rnd(rnd(kCG * dv[i][2 * h + 1]) * s + kCG * rnd(df[i][2 * h + 1]) * v);
              put_dm((HSP + HVP * c) / 8 + 2 * (pr - 2 * M) + i, h, x0, x1);
            }
        }
      }
      ring.release(q + 6 * M + pr, lane);
    };
    if constexpr (B::kDmRegs) {  // (unrolled: dmr's indices at compile time)
#pragma unroll
      for (int pr = 0; pr < 3 * M; ++pr) l2_cotangents(pr);
    } else {
#pragma unroll 1
      for (int pr = 0; pr < 3 * M; ++pr) l2_cotangents(pr);
    }
    BWD_CLOCK(3);  // layer 2's input cotangents
    __syncwarp();  // the layer-1 d_m rows are read across lanes
    // ---- layer 2's weight gradients over the round's rows (X2, Y2)
    __syncthreads();
    BWD_CLOCK(12);  // waiting for the other warps' layer 2
    wgrad_jobs<M>(wacc, nj1, njobs, wbase, wb, (it & 1) * bb, k, X2, Y2, warp, nwarps, lane);
    BWD_CLOCK(13);  // warp 0's jobs of layer 2
    __syncthreads();  // X2 and Y2 free: Y1 takes their place
    BWD_CLOCK(14);  // waiting for the other warps' jobs of layer 2
    // ---- the VJP of the layer-1 gates, on layer 1 recomputed
    {
      auto dm = [&](int nt, int e, int h) {
        if constexpr (B::kDmRegs)
          return e ? hi_of(dmr[nt][h]) : lo_of(dmr[nt][h]);
        else
          return bf(kbuf[(g + 8 * h) * LDK + nt * 8 + 2 * t4 + e]);
      };
      auto sblk = [&](int cb) {
        float o[4][4];
        l1_sblk<M>(ring, q + 9 * M + 2 * cb, lane, cl, xs, xr, d2w, rg, kCG, cb, o);
        wvjp_s(o, dm, Y1, LY, wr, cb, lane);
      };
      auto vblk = [&](int v) {
        float og[2][4], oa[2][4], ob[3][2][4];
        l1_vblk<M>(ring, q + 9 * M + 2 * (M + v), lane, cl, xs, xr, d2w, rg, kCG, v, og, oa, ob);
        wvjp_v<M>(og, oa, ob, dm, rg, Y1, LY, wr, v, lane);
      };
      if constexpr (B::kDmRegs) {  // (unrolled: dmr's indices at compile time)
#pragma unroll
        for (int cb = 0; cb < M; ++cb) sblk(cb);
#pragma unroll
        for (int v = 0; v < M; ++v) vblk(v);
      } else {
#pragma unroll 1
        for (int cb = 0; cb < M; ++cb) sblk(cb);
#pragma unroll 1
        for (int v = 0; v < M; ++v) vblk(v);
      }
    }
    __syncwarp();  // Y1's rows are read across lanes, the K-sum buffer written again
    // the d2 rows of dW0a (d2 s d_o0) and dW1Sa (d2 d_a): this lane's rows,
    // then the warp's rows (lanes g = 0 hold the sums of their columns)
    {
      const float ds0 = rg.d2(0) * rg.s(0), ds1 = rg.d2(1) * rg.s(1);
      const bf16* r0p = Y1 + (wr + g) * LY + 2 * t4;
      const bf16* r1p = r0p + 8 * LY;
#pragma unroll 4
      for (int blk = 0; blk < NP / 8; ++blk) {  // columns blk*8 + 2 t4 (+1): d_o0, then d_a
        const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(r0p + blk * 8));
        const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(r1p + blk * 8));
        const bool o0c = blk < C0 / 8;
        const float f0 = o0c ? ds0 : rg.d2(0), f1 = o0c ? ds1 : rg.d2(1);
        float pw[2] = {fmaf(f1, x1.x, f0 * x0.x), fmaf(f1, x1.y, f0 * x0.y)};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          pw[e] += __shfl_xor_sync(0xffffffffu, pw[e], 4);
          pw[e] += __shfl_xor_sync(0xffffffffu, pw[e], 8);
          pw[e] += __shfl_xor_sync(0xffffffffu, pw[e], 16);
        }
        if (g == 0) {
          d2acc[blk * 8 + 2 * t4] += pw[0];
          d2acc[blk * 8 + 2 * t4 + 1] += pw[1];
        }
      }
    }
    BWD_CLOCK(4);  // layer 1 again, its gates' VJP, the d2 rows
    // ---- layer-1 input cotangents (its row chunks): sender parts -> d_hs,
    //      receiver parts -> the K-sum buffer
    const int qa = tr.q0 + g, qb = qa + 8;
    const int live = tr.nrecv * k;
    auto dhs_row = [&](int qq) -> bf16* {
      if (qq >= live) return nullptr;
      const int rel = qq / k, kk = qq % k;
      const long node = tr.node0 + rel;
      if (TAB) return ba.scratch + ((long)tr.slot0 + qq) * f;
      if (KM) return ba.dhsp + ((long)kk * npad + node) * f;
      return ba.dhsp + (node * k + kk) * f;
    };
    bf16* hrow[2] = {dhs_row(qa), dhs_row(qb)};
    auto put = [&](int h, int pc, float x0, float x1) {
      bf16* row = hrow[h];
      if (row == nullptr) return;
      const int fc = l1mma::feat_col(sh, pc, hs, hv);
      if (fc < 0) return;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(row + fc) = __floats2bfloat162_rn(x0, x1);
      } else {
        row[fc] = __float2bfloat16(x0);
        const int fc1 = l1mma::feat_col(sh, pc + 1, hs, hv);
        if (fc1 >= 0) row[fc1] = __float2bfloat16(x1);
      }
    };
    auto put_k = [&](int h, int pc, float x0, float x1) {
      *reinterpret_cast<__nv_bfloat162*>(kbuf + (g + 8 * h) * LDK + pc) =
          __floats2bfloat162_rn(x0, x1);
    };
    // the scalar rows (sender, then receiver), 16 a chunk
#pragma unroll 1
    for (int pr = 0; pr < 4 * M; ++pr) {
      const bf16* ch = ring.acquire(q + 13 * M + pr);
      const bool snd = pr < 2 * M;
      float df[2][4], dx[2][4];
      zero(df);
      zero(dx);
#pragma unroll
      for (int kx = 0; kx < 3 * M; ++kx) {
        uint32_t a[4];
        a_frag(a, Y1, 16 * kx);
        mma_rc(df, a, ch, 16 * kx, cl);
      }
#pragma unroll
      for (int kx = 0; kx < M; ++kx) {
        uint32_t a[4];
        a_frag(a, Y1, C0 + 16 * kx);
        mma_rc(dx, a, ch, C0 + 16 * kx, cl);
      }
      ring.release(q + 13 * M + pr, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float s = rg.s(h);
          const float x0 = rnd(dx[j][2 * h] + rnd(df[j][2 * h]) * s);
          const float x1 = rnd(dx[j][2 * h + 1] + rnd(df[j][2 * h + 1]) * s);
          const int pc = 16 * (snd ? pr : pr - 2 * M) + 8 * j + 2 * t4;
          if (snd) put(h, pc, x0, x1);
          else put_k(h, pc, x0, x1);
        }
    }
    // the vector lanes (sender, then receiver)
#pragma unroll 1
    for (int pr = 0; pr < 2 * M; ++pr) {
      const bf16* ch = ring.acquire(q + 17 * M + pr);
      const bool snd = pr < M;
      float df[2][4];
      zero(df);
#pragma unroll
      for (int kx = 0; kx < 3 * M; ++kx) {
        uint32_t a[4];
        a_frag(a, Y1, 16 * kx);
        mma_rc(df, a, ch, 16 * kx, cl);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float dx[2][4];
        zero(dx);
#pragma unroll
        for (int kx = 0; kx < M; ++kx) {
          uint32_t a[4];
          a_frag(a, Y1, YV + HVP * c + 16 * kx);
          mma_rc(dx, a, ch, C0 + 16 * kx, cl);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float s = rg.s(h), v = rg.v(h, c);
            const float x0 = rnd(rnd(kCG * dx[j][2 * h]) * s + kCG * rnd(df[j][2 * h]) * v);
            const float x1 =
                rnd(rnd(kCG * dx[j][2 * h + 1]) * s + kCG * rnd(df[j][2 * h + 1]) * v);
            const int pc = HSP + HVP * c + 16 * (snd ? pr : pr - M) + 8 * j + 2 * t4;
            if (snd) put(h, pc, x0, x1);
            else put_k(h, pc, x0, x1);
          }
      }
      ring.release(q + 17 * M + pr, lane);
    }
    __syncwarp();
    BWD_CLOCK(5);  // layer 1's input cotangents, d_hs written
    ksum_tile<FLAT>(ks, kbuf, tr, k, ba.pack, hs, hv, ba.dhr, lane, sh);
    BWD_CLOCK(6);  // the K-sum of d_hr

    // ---- layer 1's weight gradients over the round's rows (the gather
    //      buffers, Y1)
    __syncthreads();
    BWD_CLOCK(7);  // waiting for the other warps' tiles
    wgrad_jobs<M>(wacc, 0, nj1, wbase, wb, (it & 1) * bb, k, X2, Y1, warp, nwarps, lane);
    BWD_CLOCK(8);  // warp 0's jobs of layer 1
    __syncthreads();
    BWD_CLOCK(9);  // waiting for the other warps' jobs of layer 1
  }

  // ---- this block's weight gradients, once: partials[block] in the six
  //      blocks' dense layout (W0a, W1Sa, W1Va, W0b, W1Sb, W1Vb)
  const int s1 = 2 * hs + 1, v1 = 2 * hv, c0 = hs + hv;
  float* out = ba.partials + (long)blockIdx.x * ((long)(s1 + v1) * c0 + (long)s1 * hv +
                                                 (long)v1 * hv + (long)c0 * c0 + (long)hs * hv +
                                                 (long)hv * hv);
  float* o_w0a = out;
  float* o_w1sa = o_w0a + (s1 + v1) * c0;
  float* o_w1va = o_w1sa + s1 * hv;
  float* o_w0b = o_w1va + v1 * hv;
  float* o_w1sb = o_w0b + c0 * c0;
  float* o_w1vb = o_w1sb + hs * hv;
  for (int q = warp; q < njobs; q += nwarps) {
    const Job jb = job_of<M>(q);
    const float4* slot = reinterpret_cast<const float4*>(wacc + (long)q * 1024) + lane;
    for (int j = 0; j < jb.nn; ++j) {
      const float4 x = slot[32 * j];
      const float acc[4] = {x.x, x.y, x.z, x.w};
      const int nt = jb.nt0 + j;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = g + 8 * (e >> 1), col = 8 * nt + 2 * t4 + (e & 1);
        if (jb.kind == 0) {  // rows of the scalar inputs x [O0 -> w0 | OA -> w1s]
          const bool rcv = jb.layer == 1 && jb.mt >= 2 * M;
          const int pr = 16 * (rcv ? jb.mt - 2 * M : jb.mt) + m;
          if (pr >= hs) continue;
          const int i = (rcv ? hs : 0) + pr;
          int o, jj;
          l1mma::out_col(sh, col, hs, hv, o, jj);
          float* w0 = jb.layer == 1 ? o_w0a : o_w0b;
          float* w1 = jb.layer == 1 ? o_w1sa : o_w1sb;
          if (o >= 0) w0[i * c0 + o] = acc[e];
          else if (jj >= 0) w1[i * hv + jj] = acc[e];
        } else {
          const bool rcv = jb.layer == 1 && jb.mt >= M;
          const int pr = 16 * (rcv ? jb.mt - M : jb.mt) + m;
          if (pr >= hv) continue;
          if (jb.kind == 1) {  // w1v's rows (times CG011)
            if (col < hv) (jb.layer == 1 ? o_w1va : o_w1vb)[((rcv ? hv : 0) + pr) * hv + col] =
                kCG * acc[e];
          } else {  // w0's dot rows (times CG110)
            int o, jj;
            l1mma::out_col(sh, col, hs, hv, o, jj);
            const int i = jb.layer == 1 ? s1 + (rcv ? hv : 0) + pr : hs + pr;
            if (o >= 0) (jb.layer == 1 ? o_w0a : o_w0b)[i * c0 + o] = kCG * acc[e];
          }
        }
      }
    }
  }
  // the d2 rows: the warps' sums in warp order
  __syncthreads();
  for (int col = threadIdx.x; col < NP; col += blockDim.x) {
    float acc = 0.f;
    for (int w = 0; w < nwarps; ++w) acc += reinterpret_cast<const float*>(wbase + w * wb + d2off)[col];
    int o, jj;
    l1mma::out_col(sh, col, hs, hv, o, jj);
    if (o >= 0) o_w0a[2 * hs * c0 + o] = acc;
    else if (jj >= 0) o_w1sa[2 * hs * hv + jj] = acc;
  }
  if (!TAB) return;
  __syncthreads();  // the staging region becomes the table sum's ints
  for (int j = 0; j < my_items; ++j) {
    const long tl = blockIdx.x + (long)j * gridDim.x;  // the gather tile
    table_sum(ga.loc + tl * tile * k, ba.scratch + tl * tile * k * f, ba.dhu + tl * u * f,
              PERM, START, CUR, tile * k, u, f, warp, lane, nwarps);
  }
  BWD_CLOCK(10);  // the block's weight gradients written, its tiles' table sums
}

template <Addr A>
long grid(int k, int tile, int u, long items) {
  const long smem = smem_bytes(k, tile, u);
  auto kern = fused_message_bwd_mma<A>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(long)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return -(long)err;
  if (per_sm < 1) return -(long)cudaErrorInvalidConfiguration;
  const long gr = (long)sms * per_sm;
  return gr < items ? gr : items;
}

// The Wide kernel's instance M over n receivers (TAB: tiles of tile): its
// block count (SMs x resident blocks, at most one per item), and its warps a
// block and blocks an SM where asked; negative: -(CUDA error)
template <Addr A, int M>
long grid_wide_m(int k, int tile, int u, long n, int* warps_out = nullptr,
                 int* per_sm_out = nullptr) {
  typedef BwdWide<A, M> B;
  const int tl = A == Addr::kTab ? tile : 0, uu = A == Addr::kTab ? u : 0;
  const int warps = B::warps(k, tl, uu);
  if (warps_out != nullptr) *warps_out = warps;
  if (warps < 1) return -(long)cudaErrorInvalidValue;
  const long smem = B::smem_bytes(k, tl, uu, warps);
  auto kern = fused_message_bwd_wide_mma<A, M>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(long)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 32 * warps, smem);
  if (err != cudaSuccess) return -(long)err;
  if (per_sm_out != nullptr) *per_sm_out = per_sm;
  if (per_sm < 1) return -(long)cudaErrorInvalidConfiguration;
  long items;
  if (A == Addr::kTab) {
    items = n / tile;
  } else {
    const int G = unit_recv(k, 0);
    items = ((n + G - 1) / G + warps - 1) / warps;
  }
  const long gr = (long)sms * per_sm;
  return gr < items ? gr : items;
}
template <Addr A>
long grid_wide(int hs, int hv, int k, int tile, int u, long n, int* warps_out = nullptr,
               int* per_sm_out = nullptr) {
  if (hs < 1 || hv < 0) return -(long)cudaErrorInvalidValue;
#define CALL(m) return grid_wide_m<A, m>(k, tile, u, n, warps_out, per_sm_out)
  switch (wide_m(hs, hv)) { LMAX1_WIDE_CASES(CALL) }
#undef CALL
  return -(long)cudaErrorInvalidValue;
}

// the block count of a launch over n receivers (TAB: tiles of tile) on the
// Bench kernel, or (WIDE) the Wide kernel
template <Addr A, bool WIDE>
long grid_for(int hs, int hv, int k, int tile, int u, long n) {
  if constexpr (WIDE) {
    return grid_wide<A>(hs, hv, k, tile, u, n);
  } else {
    if (!fits(hs, hv)) return -(long)cudaErrorInvalidValue;
    if (A == Addr::kTab) return grid<A>(k, tile, u, n / tile);
    const int G = unit_recv(k, 0);
    const long units = (n + G - 1) / G;
    return grid<A>(k, 0, 0, (units + kWarps - 1) / kWarps);
  }
}

// Of this library's bf16 main kernel: the shared memory a block takes (the
// Wide kernels: the instance's; past the largest, one past the limit); and of
// the Wide kernels' buffer past the partials, the floats a block of the
// weight-gradient accumulators and the floats of the packed weights
__host__ inline long bf16_smem_bytes(int hs, int hv, int k, int tile, int u) {
  if (!kWideLibrary) return smem_bytes(k, tile, u);
#define CALL(m)                                                               \
  return BwdWide<Addr::kTab, m>::smem_bytes(                                  \
      k, tile, u, BwdWide<Addr::kTab, m>::warps(k, tile, u) > 0               \
                      ? BwdWide<Addr::kTab, m>::warps(k, tile, u) : 1)
  switch (wide_m(hs, hv)) { LMAX1_WIDE_CASES(CALL) }
#undef CALL
  return gmma::kMaxSmem + 1;
}
__host__ inline long bf16_wacc_floats(int hs, int hv) {
  if (!kWideLibrary) return 0;
#define CALL(m) return wide_wacc_floats<m>()
  switch (wide_m(hs, hv)) { LMAX1_WIDE_CASES(CALL) }
#undef CALL
  return 0;
}
__host__ inline long bf16_pack_floats(int hs, int hv) {
  if (!kWideLibrary) return 0;
#define CALL(m) return (WidePack<m>::BYTES + 15) / 16 * 4
  switch (wide_m(hs, hv)) { LMAX1_WIDE_CASES(CALL) }
#undef CALL
  return 0;
}
// where the Wide kernel's accumulators start past partials [grid][NW]: a
// multiple of 4 floats (16-byte loads)
__host__ inline long wacc_offset(int hs, int hv, int grid) {
  const long nw = (2L * hs + 1 + 2L * hv) * (hs + hv) + (2L * hs + 1) * hv + 2L * hv * hv +
                  (long)(hs + hv) * (hs + hv) + (long)hs * hv + (long)hv * hv;
  return ((long)grid * nw + 3) / 4 * 4;
}

// The Wide kernel's instance M: the packed weights (after the accumulators),
// then the main kernel
template <Addr A, int M>
int launch_wide_m(const GatherArgs& ga, BwdArgs ba, const void* const* w, int grid,
                  cudaStream_t stream) {
  typedef BwdWide<A, M> B;
  const int tl = A == Addr::kTab ? ga.tile : 0, uu = A == Addr::kTab ? ga.u : 0;
  const int warps = B::warps(ga.k, tl, uu);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const long smem = B::smem_bytes(ga.k, tl, uu, warps);
  auto kern = fused_message_bwd_wide_mma<A, M>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  unsigned char* pk = reinterpret_cast<unsigned char*>(ba.wacc + (long)grid * wide_wacc_floats<M>());
  auto wt = [w](int i) { return static_cast<const bf16*>(w[i]); };
  l1mma::lmax1_wide_pack<false, M><<<sms, 256, 0, stream>>>(pk, wt(0), wt(1), wt(2), wt(3), wt(4),
                                                            wt(5), ga.hs, ga.hv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, 32 * warps, smem, stream>>>(ga, pk, ba);
  return (int)cudaGetLastError();
}

// in: h, d2, attr, maskf, loc, gtab, hs3 or hs, geo2, six weights, d_agg
// (the unused ones null); out: d_hu, d_hr, d_hs scratch, d_hs (KM, FLAT)
template <Addr A, bool WIDE>
int launch(const void* const* in, void* const* out, float* partials, int npad, int hs, int hv,
           int k, int tile, int u, int pack, int grid, cudaStream_t stream) {
  if (hs < 1 || hv < 0 || (!WIDE && !fits(hs, hv)) || grid < 1 ||
      (A == Addr::kTab && npad % tile != 0) || pack < 1 || k % pack != 0)
    return (int)cudaErrorInvalidValue;
  GatherArgs ga;
  ga.h = static_cast<const bf16*>(in[0]);
  ga.d2 = static_cast<const bf16*>(in[1]);
  ga.attr = static_cast<const bf16*>(in[2]);
  ga.maskf = static_cast<const bf16*>(in[3]);
  ga.loc = static_cast<const int*>(in[4]);
  ga.gtab = static_cast<const int*>(in[5]);
  ga.hsp = static_cast<const bf16*>(in[6]);
  ga.geo2 = static_cast<const bf16*>(in[7]);
  ga.dagg = static_cast<const bf16*>(in[14]);
  ga.npad = npad; ga.hs = hs; ga.hv = hv; ga.k = k; ga.tile = tile; ga.u = u;
  ga.mode = copy_mode(hs, hv, {in[0], in[6], in[14]});
  BwdArgs ba;
  ba.dhu = static_cast<bf16*>(out[0]);
  ba.dhr = static_cast<bf16*>(out[1]);
  ba.scratch = static_cast<bf16*>(out[2]);
  ba.dhsp = static_cast<bf16*>(out[3]);
  ba.partials = partials;
  ba.wacc = partials + wacc_offset(hs, hv, grid);
  ba.pack = pack;
  if constexpr (WIDE) {
#define CALL(m) return launch_wide_m<A, m>(ga, ba, in + 8, grid, stream)
    switch (wide_m(hs, hv)) { LMAX1_WIDE_CASES(CALL) }
#undef CALL
    return (int)cudaErrorInvalidValue;
  } else {
    const int tl = A == Addr::kTab ? tile : 0;
    const long smem = smem_bytes(k, tl, u);
    auto kern = fused_message_bwd_mma<A>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    auto wt = [in](int i) { return static_cast<const bf16*>(in[i]); };
    kern<<<grid, kThreads, smem, stream>>>(ga, wt(8), wt(9), wt(10), wt(11), wt(12), wt(13), ba);
    return (int)cudaGetLastError();
  }
}

}  // namespace mma

// blocks: SMs x resident blocks, at most one per unit (tile, or group)
template <typename T, Addr A>
int grid_for(const Dims& d, int units) {
  const long smem = smem_bytes(d);
  if (smem > gmma::kMaxSmem) return -(int)cudaErrorInvalidValue;
  auto kern = fused_message_tab_bwd_kernel<T, A>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  const int grid = sms * per_sm;
  return grid < units ? grid : units;
}

// in: h, d2, attr, maskf, loc, gtab, hs3 or hs, geo2, six weights, d_agg
// (the unused ones null); out: d_hu, d_hr, d_hs scratch, d_hs (KM, FLAT)
template <typename T, Addr A>
int launch(const void* const* in, void* const* out, float* partials, int npad, int hs,
           int hv, int k, int tile, int u, int pack, int grid, cudaStream_t stream) {
  const Dims d = make_dims(hs, hv, k, tile, u);
  const long smem = smem_bytes(d);
  auto kern = fused_message_tab_bwd_kernel<T, A>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (grid < 1 || (A == Addr::kTab && npad % tile != 0) || pack < 1 || k % pack != 0)
    return (int)cudaErrorInvalidValue;
  auto t = [in](int i) { return static_cast<const T*>(in[i]); };
  kern<<<grid, kThreads, smem, stream>>>(
      t(0), t(1), t(2), t(3), static_cast<const int*>(in[4]), static_cast<const int*>(in[5]),
      t(6), t(7), t(8), t(9), t(10), t(11), t(12), t(13), t(14), static_cast<T*>(out[0]),
      static_cast<T*>(out[1]), static_cast<T*>(out[2]), static_cast<T*>(out[3]), partials,
      npad, hs, hv, k, tile, u, pack);
  return (int)cudaGetLastError();
}

// The library's launch and grid of a dtype: built plain, fp32 on the FMA
// kernel and bf16 on the Bench kernel (up to 32x0e+16x1o); built with
// LMAX1_WIDE=1 and LMAX1_WIDE_M=m (a library of this source for each
// instance, compiled beside the first), bf16 on the Wide kernel's instance
// m.  The wrapper picks the library by the widths.
template <Addr A>
int launch_dtype(int dtype, const void* const* in, void* const* out, float* partials, int npad,
                 int hs, int hv, int k, int tile, int u, int pack, int grid, cudaStream_t st) {
  if constexpr (kWideLibrary) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return mma::launch<A, true>(in, out, partials, npad, hs, hv, k, tile, u, pack, grid, st);
  } else {
    if (dtype == 0)
      return launch<float, A>(in, out, partials, npad, hs, hv, k, tile, u, pack, grid, st);
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return mma::launch<A, false>(in, out, partials, npad, hs, hv, k, tile, u, pack, grid, st);
  }
}

template <Addr A>
long grid_dtype(int dtype, int hs, int hv, int k, int tile, int u, long n) {
  if constexpr (kWideLibrary) {
    if (dtype != 1) return -(long)cudaErrorInvalidValue;
    return mma::grid_for<A, true>(hs, hv, k, tile, u, n);
  } else {
    const Dims d = make_dims(hs, hv, k, A == Addr::kTab ? tile : 0, A == Addr::kTab ? u : 0);
    const int units = A == Addr::kTab ? (int)(n / tile) : (int)((n + d.g - 1) / d.g);
    if (dtype == 0) return grid_for<float, A>(d, units);
    if (dtype != 1) return -(long)cudaErrorInvalidValue;
    return mma::grid_for<A, false>(hs, hv, k, tile, u, n);
  }
}

}  // namespace

extern "C" {

// Shared memory one block of the main kernel needs in this library (bytes;
// dtype 0 = float32, 1 = bfloat16); the wrapper checks it against the
// card's limit before launching.
long fused_message_tab_bwd_smem_bytes(int dtype, int hs, int hv, int k, int tile, int u) {
  return dtype == 0 ? smem_bytes(make_dims(hs, hv, k, tile, u))
                    : mma::bf16_smem_bytes(hs, hv, k, tile, u);
}

// The floats of the buffer the main kernel's partials [grid][NW] start (fp32,
// 16-byte aligned): the partials, then (the Wide kernel) its weight-gradient
// accumulators [grid][jobs * 1024] from the next multiple of 4 floats, then
// its packed weights.
long fused_message_bwd_partials_floats(int dtype, int hs, int hv, int grid) {
  if (dtype == 0) return mma::wacc_offset(hs, hv, grid);
  return mma::wacc_offset(hs, hv, grid) + grid * mma::bf16_wacc_floats(hs, hv) +
         mma::bf16_pack_floats(hs, hv);
}

// Blocks of the main kernel (SMs x resident blocks, at most one per tile),
// which sizes the per-block scratch and partials; negative: -(CUDA error).
int fused_message_tab_bwd_grid(int dtype, int hs, int hv, int k, int tile, int u, int ntiles) {
  return (int)grid_dtype<Addr::kTab>(dtype, hs, hv, k, tile, u, (long)ntiles * tile);
}

// dtype: 0 = float32, 1 = bfloat16.  Inputs h, d2, attr, maskf, loc, gtab,
// the six weight blocks and d_agg; outputs d_hu, d_hr; scratch (data type;
// float32 [grid][tile*k][F], bfloat16 [Npad*k][F]) and partials [grid][NW]
// (fp32, in a buffer of fused_message_bwd_partials_floats).  Returns
// cudaGetLastError() after the launch (0 on success).
int fused_message_tab_bwd(int dtype, const void* h, const void* d2, const void* attr,
                          const void* maskf, const void* loc, const void* gtab,
                          const void* w0a, const void* w1sa, const void* w1va,
                          const void* w0b, const void* w1sb, const void* w1vb,
                          const void* dagg, void* dhu, void* dhr, void* scratch,
                          void* partials, int npad, int hs, int hv, int k, int tile, int u,
                          int grid, void* stream) {
  const void* in[15] = {h,   d2,   attr, maskf, loc,  gtab, nullptr, nullptr,
                        w0a, w1sa, w1va, w0b,   w1sb, w1vb, dagg};
  void* const out[4] = {dhu, dhr, scratch, nullptr};
  return launch_dtype<Addr::kTab>(dtype, in, out, static_cast<float*>(partials), npad, hs, hv, k,
                                  tile, u, 1, grid, static_cast<cudaStream_t>(stream));
}

// The untabled (km) backward's main kernel.
long fused_message_km_bwd_smem_bytes(int dtype, int hs, int hv, int k) {
  return dtype == 0 ? smem_bytes(make_dims(hs, hv, k, 0, 0))
                    : mma::bf16_smem_bytes(hs, hv, k, 0, 0);
}

int fused_message_km_bwd_grid(int dtype, int hs, int hv, int k, int n) {
  return (int)grid_dtype<Addr::kKm>(dtype, hs, hv, k, 0, 0, n);
}

// Inputs hs3 [K, N, F], hr [N, F], geo2 [N, K*6], the six weight blocks and
// d_agg [N, F]; outputs d_hs [K, N, F], d_hr [N, F] and the partials
// [grid][NW] (fp32).  Returns cudaGetLastError() after the launch.
int fused_message_km_bwd(int dtype, const void* hs3, const void* hr, const void* geo2,
                         const void* w0a, const void* w1sa, const void* w1va,
                         const void* w0b, const void* w1sb, const void* w1vb,
                         const void* dagg, void* dhs, void* dhr, void* partials, int n,
                         int hs, int hv, int k, int grid, void* stream) {
  const void* in[15] = {hr,  nullptr, nullptr, nullptr, nullptr, nullptr, hs3, geo2,
                        w0a, w1sa,    w1va,    w0b,     w1sb,    w1vb,    dagg};
  void* const out[4] = {nullptr, dhr, nullptr, dhs};
  return launch_dtype<Addr::kKm>(dtype, in, out, static_cast<float*>(partials), n, hs, hv, k, 0,
                                 0, 1, grid, static_cast<cudaStream_t>(stream));
}

// The packed node-major backward's main kernel (#7); its shared memory is
// the km kernel's (fused_message_km_bwd_smem_bytes).
int fused_message_flat_bwd_grid(int dtype, int hs, int hv, int k, int n) {
  return (int)grid_dtype<Addr::kFlat>(dtype, hs, hv, k, 0, 0, n);
}

// Inputs hs [N*K, F] (the TPU's [N*K/p, p*F]), hr [N, F], d2 [N*K], attr
// [N*K, 4], maskf [N*K], the six weight blocks and d_agg [N, F]; outputs
// d_hs [N*K, F], d_hr [N, F] and the partials [grid][NW] (fp32); pack
// divides K.  Returns cudaGetLastError() after the launch.
int fused_message_flat_bwd(int dtype, const void* hs_rows, const void* hr, const void* d2,
                           const void* attr, const void* maskf, const void* w0a,
                           const void* w1sa, const void* w1va, const void* w0b,
                           const void* w1sb, const void* w1vb, const void* dagg, void* dhs,
                           void* dhr, void* partials, int n, int hs, int hv, int k, int pack,
                           int grid, void* stream) {
  const void* in[15] = {hr,  d2,   attr, maskf, nullptr, nullptr, hs_rows, nullptr,
                        w0a, w1sa, w1va, w0b,   w1sb,    w1vb,    dagg};
  void* const out[4] = {nullptr, dhr, nullptr, dhs};
  return launch_dtype<Addr::kFlat>(dtype, in, out, static_cast<float*>(partials), n, hs, hv, k,
                                   0, 0, pack, grid, static_cast<cudaStream_t>(stream));
}

// The Wide kernel of an addressing (0 tabled, 1 km, 2 flat) at these widths
// over n receivers: out[0] its warps a block, out[1] its blocks an SM (the
// occupancy query); returns its shared memory a block (bytes), or -1 (no
// instance, or not the Wide library).
long lmax1_wide_bwd_config(int addr, int hs, int hv, int k, int tile, int u, int n, int* out) {
  out[0] = out[1] = 0;
#if !LMAX1_WIDE
  return -1;
#else
  long g;
  if (addr == 0) g = mma::grid_wide<Addr::kTab>(hs, hv, k, tile, u, n, out, out + 1);
  else if (addr == 1) g = mma::grid_wide<Addr::kKm>(hs, hv, k, 0, 0, n, out, out + 1);
  else g = mma::grid_wide<Addr::kFlat>(hs, hv, k, 0, 0, n, out, out + 1);
  if (g < 0) return -1;
  return mma::bf16_smem_bytes(hs, hv, k, addr == 0 ? tile : 0, addr == 0 ? u : 0);
#endif
}

#ifdef LMAX1_BWD_CLOCKS
// the bf16 engine's phases' cycles (thread 0 of every block) and rounds,
// summed since the last call (then 0)
int lmax1_bwd_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, bwd_phase_cycles, sizeof(bwd_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(bwd_phase_cycles, zero, sizeof(zero));
}
#endif

// The fixed-order reduction of the weight-gradient partials [nblocks, nw]
// into out [nw]: reduce_cols where cols is 1, else reduce_strips.  Returns
// cudaGetLastError() after the launch.
int fused_message_tab_bwd_reduce(const void* partials, void* out, int nblocks, int nw, int cols,
                                 void* stream) {
  if (nw < 1 || nblocks < 0 ||
      (cols && (nw % 4 || (reinterpret_cast<uintptr_t>(partials) |
                           reinterpret_cast<uintptr_t>(out)) % 16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cols) {
    const int nv = nw / 4;
    fused_message_tab_bwd_reduce_cols<<<(nv + kColThreads - 1) / kColThreads, kColThreads, 0,
                                        st>>>(static_cast<const float4*>(partials),
                                              static_cast<float4*>(out), nblocks, nv);
  } else {
    fused_message_tab_bwd_reduce_strips<<<(nw + kStripCols - 1) / kStripCols, kStripWarps * 32,
                                          0, st>>>(static_cast<const float*>(partials),
                                                   static_cast<float*>(out), nblocks, nw);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
