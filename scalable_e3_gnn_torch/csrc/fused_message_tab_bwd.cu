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
//   scratch rows in global memory (L2-resident), then, per tile, builds the
//   inverse of loc in shared memory (counting sort, each bucket sorted by
//   slot) and sums every table row's slots in slot order: no float atomics.
// - The weight gradients accumulate in shared memory, each entry owned by
//   one thread, and are written once per block.
// - The TPU's one-hot MXU expansions (onehot, onehot^T, the E/E^T expand
//   matrices) are layouts for its matrix unit: here each slot reads its sender
//   row as h[gtab[tile, loc]] and receivers sum their K slots in shared memory.
// Per group of G receivers (G*K slot rows, 48 at K=24) the block stages the
// layer-1 inputs, runs the small GEMMs of both layers forward and backward
// from shared memory on the fp32 FMA units (each thread a 4-row x 1-column
// register tile; the GEMMs of one phase share one work list), and keeps the
// residuals of both layers for the VJP.  Weights sit in shared memory with
// an odd row stride, so the transposed reads of the VJP are conflict-free.
//
// Bound.  Per slot the recompute costs 10,816 multiply-adds at Hs=32, Hv=16
// and the VJP twice that (an input-gradient and a weight-gradient product for
// every forward product): 32,448, so about 136 GFLOP for the 2.09M valid
// slots of config 3, against about 150 MB of traffic.  The kernel is bound
// by operations (about 0.14 ms at the bf16 tensor-core peak, 2 ms at the fp32
// FMA peak).  This first version runs on the fp32 FMA units out of shared
// memory; tensor cores (mma/wgmma on the bf16 operands) are later work.
// With KM the kernel reads hs3 and writes d_hs, 384 MB each in bf16 at
// config 3, so it is bound by bytes (about 0.25 ms at 3.35 TB/s); so with
// FLAT, which reads hs and writes d_hs of the same size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kCG110 = 0.57735026918962576451f;  // 1/sqrt(3)
constexpr float kCG011 = 0.57735026918962576451f;  // 1/sqrt(3)
constexpr int kThreads = 512;
constexpr int kMT = 4;           // rows per thread in the small GEMMs
constexpr int kTargetRows = 48;  // slot rows per group (G = max(1, 48 / K))
constexpr int kMaxMm = 6;        // GEMMs in one phase

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to the data type and widened back to fp32
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__host__ __device__ inline int odd(int n) { return n | 1; }

// where a slot's sender row, geometry and sender cotangent are
enum class Addr {
  kTab,   // h[gtab[tile, loc[e]]]; d2, attr, maskf at e = i*K + k; d_hu by the table
  kKm,    // row k*N + i of hs3 [K, N, F] and of d_hs; geo2 [N, K*6]
  kFlat,  // row e = i*K + k of hs [N*K, F] and of d_hs; d2, attr, maskf at e
};

struct Dims {
  int hs, hv, k, g, rows, rows_p;  // rows = g*k, rows_p = rows rounded to kMT
  int s1, v1, c0, f;               // 2hs+1, 2hv, hs+hv, hs+3hv
  int tile, u;
  int ld0a, ld1a, ld0b, ld1b;      // odd row strides of the weights in shared memory
  long wts, nw;                    // floats: padded weights, dense weight gradients
  long reg_a, reg_b;               // per-row floats of the two row regions
  long region;                     // floats of the whole row region (also the CSR ints)
};

// tile = u = 0: the untabled kernels (KM, FLAT), which have no table
__host__ __device__ inline Dims make_dims(int hs, int hv, int k, int tile, int u) {
  Dims d;
  d.hs = hs; d.hv = hv; d.k = k; d.tile = tile; d.u = u;
  d.g = k >= kTargetRows ? 1 : kTargetRows / k;
  if (tile > 0 && d.g > tile) d.g = tile;
  d.rows = d.g * k;
  d.rows_p = (d.rows + kMT - 1) / kMT * kMT;
  d.s1 = 2 * hs + 1; d.v1 = 2 * hv; d.c0 = hs + hv; d.f = hs + 3 * hv;
  d.ld0a = odd(d.c0); d.ld1a = odd(hv); d.ld0b = odd(d.c0); d.ld1b = odd(hv);
  d.wts = (long)(d.s1 + d.v1) * d.ld0a + (long)d.s1 * d.ld1a + (long)d.v1 * d.ld1a +
          (long)d.c0 * d.ld0b + (long)hs * d.ld1b + (long)hv * d.ld1b;
  d.nw = (long)(d.s1 + d.v1) * d.c0 + (long)d.s1 * hv + (long)d.v1 * hv + (long)d.c0 * d.c0 +
         (long)hs * hv + (long)hv * hv;
  // A: XS1 [s1], X01 [s1+v1], XV1 [3 v1], O01 [c0], O11 [3 hv]; then OA [hv], GEO [5]
  d.reg_a = d.s1 + (d.s1 + d.v1) + 3L * d.v1 + d.c0 + 3L * hv;
  // B, layer 2: XS2 [hs], X02 [c0], XV2 [3hv], O02 [c0], O12 [3hv], DXV2 [3hv], DXS2 [hs], DF02 [c0]
  const long b2 = 2L * hs + 3L * d.c0 + 9L * hv;
  // B, layer 1: DXV1 [3 v1], DXS1 [2 hs], DF01 [s1+v1]
  const long b1 = 3L * d.v1 + 2L * hs + (d.s1 + d.v1);
  d.reg_b = b2 > b1 ? b2 : b1;
  const long rows_region = d.rows_p * (d.reg_a + hv + 5 + d.reg_b) + (long)d.g * d.f;
  const long csr = (long)tile * k + 2L * u + 1;  // PERM, START, CUR (ints)
  d.region = rows_region > csr ? rows_region : csr;
  return d;
}

// shared memory: weights, weight gradients, the row region, sender ids
__host__ inline size_t smem_bytes(const Dims& d) {
  return sizeof(float) * (d.wts + d.nw + d.region) + sizeof(int) * d.rows_p;
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
  // weights (padded rows) and the weight gradients (dense, in the partials' order)
  float* W0a = smem;                        // [s1+v1][ld0a]
  float* W1Sa = W0a + (s1 + v1) * d.ld0a;   // [s1][ld1a]
  float* W1Va = W1Sa + s1 * d.ld1a;         // [v1][ld1a]
  float* W0b = W1Va + v1 * d.ld1a;          // [c0][ld0b]
  float* W1Sb = W0b + c0 * d.ld0b;          // [hs][ld1b]
  float* W1Vb = W1Sb + hs * d.ld1b;         // [hv][ld1b]
  float* DW = W1Vb + hv * d.ld1b;
  float* dW0a = DW;
  float* dW1Sa = dW0a + (s1 + v1) * c0;
  float* dW1Va = dW1Sa + s1 * hv;
  float* dW0b = dW1Va + v1 * hv;
  float* dW1Sb = dW0b + c0 * c0;
  float* dW1Vb = dW1Sb + hs * hv;
  float* RG = DW + d.nw;
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
    for (int m = 0; m < 6; ++m)
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

  for (long i = threadIdx.x; i < d.nw; i += blockDim.x)
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

// blocks: SMs x resident blocks, at most one per unit (tile, or group)
template <typename T, Addr A>
int grid_for(const Dims& d, int units) {
  const size_t smem = smem_bytes(d);
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
  const size_t smem = smem_bytes(d);
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

}  // namespace

extern "C" {

// Shared memory one block of the main kernel needs (bytes); the wrapper
// checks it against the card's limit before launching.
long fused_message_tab_bwd_smem_bytes(int hs, int hv, int k, int tile, int u) {
  return (long)smem_bytes(make_dims(hs, hv, k, tile, u));
}

// Blocks of the main kernel (SMs x resident blocks, at most one per tile),
// which sizes the per-block scratch; negative: -(CUDA error).
int fused_message_tab_bwd_grid(int dtype, int hs, int hv, int k, int tile, int u, int ntiles) {
  const Dims d = make_dims(hs, hv, k, tile, u);
  if (dtype == 0) return grid_for<float, Addr::kTab>(d, ntiles);
  if (dtype == 1) return grid_for<__nv_bfloat16, Addr::kTab>(d, ntiles);
  return -(int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16.  Inputs h, d2, attr, maskf, loc, gtab,
// the six weight blocks and d_agg; outputs d_hu, d_hr; scratch [grid][tile*k][F]
// (data type) and partials [grid][NW] (fp32).  Returns cudaGetLastError()
// after the launch (0 on success).
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  if (dtype == 0)
    return launch<float, Addr::kTab>(in, out, part, npad, hs, hv, k, tile, u, 1, grid, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, Addr::kTab>(in, out, part, npad, hs, hv, k, tile, u, 1, grid,
                                             st);
  return (int)cudaErrorInvalidValue;
}

// The untabled (km) backward's main kernel.
long fused_message_km_bwd_smem_bytes(int hs, int hv, int k) {
  return (long)smem_bytes(make_dims(hs, hv, k, 0, 0));
}

int fused_message_km_bwd_grid(int dtype, int hs, int hv, int k, int n) {
  const Dims d = make_dims(hs, hv, k, 0, 0);
  const int groups = (n + d.g - 1) / d.g;
  if (dtype == 0) return grid_for<float, Addr::kKm>(d, groups);
  if (dtype == 1) return grid_for<__nv_bfloat16, Addr::kKm>(d, groups);
  return -(int)cudaErrorInvalidValue;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  if (dtype == 0)
    return launch<float, Addr::kKm>(in, out, part, n, hs, hv, k, 0, 0, 1, grid, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, Addr::kKm>(in, out, part, n, hs, hv, k, 0, 0, 1, grid, st);
  return (int)cudaErrorInvalidValue;
}

// The packed node-major backward's main kernel (#7); its shared memory is
// the km kernel's (fused_message_km_bwd_smem_bytes).
int fused_message_flat_bwd_grid(int dtype, int hs, int hv, int k, int n) {
  const Dims d = make_dims(hs, hv, k, 0, 0);
  const int groups = (n + d.g - 1) / d.g;
  if (dtype == 0) return grid_for<float, Addr::kFlat>(d, groups);
  if (dtype == 1) return grid_for<__nv_bfloat16, Addr::kFlat>(d, groups);
  return -(int)cudaErrorInvalidValue;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  if (dtype == 0)
    return launch<float, Addr::kFlat>(in, out, part, n, hs, hv, k, 0, 0, pack, grid, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, Addr::kFlat>(in, out, part, n, hs, hv, k, 0, 0, pack, grid,
                                              st);
  return (int)cudaErrorInvalidValue;
}

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
