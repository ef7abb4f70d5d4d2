// lmax=1 fused message + aggregation, forward, for Hopper (sm_90a): the
// tabled kernel (#1) and, by a compile-time sender addressing (Addr), the
// untabled slot-major one (#3/#4) and the packed node-major one (#6).
//
// Replaces the TPU kernels scalable_e3_gnn_tpu/kernels/fused_message.py::
// _fwd_kernel_tab (via _fwd_tail, _build_inputs, _layer_fwd), with KM
// _fwd_kernel_km2 (the default GEMM form, via _tp_layer_km2) and
// _fwd_kernel_km (the stacked-lane form of the same function), and with
// FLAT _fwd_kernel (via _fwd_tail, the pack > 1 path).  For every
// receiver i and neighbour slot k it computes the two gated L1 tensor-product
// layers of the SEGNN message MLP on [h_s || h_r || d^2] with the edge's sh
// attribute, masks the slot and sums over k:
//
//   agg[i] = sum_k mask[i,k] * MLP2(MLP1([h_s || h_r || d2], sh), sh)
//
// with the sender row h_s = h[gtab[i / tile, loc[i,k]]] (loc == U: no sender,
// a zero row).  With KM the senders come pre-gathered slot-major, hs3
// [K, N, F] (slot k of receiver i is row k*N + i), and the geometry from the
// node-major geo2 [N, K*6] row of the receiver (sh 4, d2, mask per slot);
// there is no table.  With FLAT the senders come pre-gathered node-major, hs
// [N*K, F] (slot k of receiver i is row e = i*K + k: the TPU's [N*K/p, p*F]
// packed rows are the same memory), and the geometry from the flat d2, attr
// and maskf rows e, as the tabled kernel reads them.  The TPU kernel expands
// a per-tile table hu = h[gtab] to slot rows with a one-hot MXU matmul; here
// each slot reads its sender row directly through the table, so hu is never
// written to device memory, and h (16 MB in bf16 at 100k x 80) stays in the
// 50 MB L2.
//
// Bound.  Per slot the two layers do (S1+V1)(Hs+Hv) + S1 Hv + 3 V1 Hv +
// (Hs+Hv)^2 + Hs Hv + 3 Hv^2 multiply-adds: 10,816 at Hs=32, Hv=16, about
// 52 GFLOP per call at 100k x 24 slots, against about 70 MB of bf16 traffic
// (h from L2).  So the tabled work is bound by operations on this card
// (about 52 us at the bf16 tensor-core peak, 21 us of memory time).  With KM
// the kernel reads hs3 whole (384 MB in bf16 at 100k x 24 slots), so bytes
// bound it (about 0.13 ms at 3.35 TB/s); FLAT reads hs whole the same way.
//
// Design, bf16 (the engine of lmax1_mma.cuh): every product runs on the
// tensor cores (mma.sync m16n8k16, bf16 operands, fp32 accumulators).  A
// warp owns 16-row tiles of units of whole receivers (48 slot rows at K=24):
// both layers, the gates, the mask and the K-sum stay in the warp, the
// layer-1 outputs pass to layer 2 in registers (C fragments become A
// fragments), and the only block barrier follows the weights' staging.  Per
// 16 rows that is 120 mma (1.42x the counted work: the dot lanes run as
// three products).  Each warp fetches its next tile's rows by cp.async while
// it multiplies the current one.  Three blocks of four warps share an SM.
// Past 32x0e+16x1o the Wide kernel (an instance per count m of 32-lane
// scalar and 16-channel vector blocks, m = 1..4) walks the same units a
// column block at a time: the layer-1 outputs pass to layer 2 in registers
// (20 m registers a lane), the weights stream through a ring of column-block
// chunks shared by the block's warps (cp.async.bulk against mbarriers; no
// block holds a whole width's weights), and the K-sum buffer is bf16 (TAB,
// KM), so eight warps an SM fit up to 64x0e+32x1o.
// fp32 (the check path): the first form, kept: one block walks groups of G
// receivers (fewer where a wide layer's rows would not fit beside its
// weights), stages the layer-1 inputs of every slot row in shared memory
// and runs the small GEMMs of each layer on the fp32 FMA units (each thread
// a 4-row x 1-column accumulator tile), with block barriers between the
// phases.
//
// Rounding.  The tabled kernel rounds as the stacked-lane TPU form: the
// layer-1 outputs and each masked slot message to the data type.  With KM it
// also rounds where the km2 form does: the W0 vector rows are scaled by
// CG110 and rounded in the data type when they are staged (so the dot lanes
// are not scaled), and A and the gate's sigmoid are rounded before use.
// FLAT rounds as the tabled kernel, except in the K-sum: the TPU's packed
// form (_fwd_tail with pack = p) adds the p masked slot messages of a group
// in fp32, rounds that sum once to the data type, and sums the K/p groups in
// fp32; pack = 1 is the tabled kernel's rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
constexpr int kThreads = 256;
constexpr int kRowTile = 4;     // rows per thread in the small GEMMs
constexpr int kTargetRows = 48; // slot rows per group (G = max(1, 48 / K))

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// x rounded to the data type and widened back to fp32
template <typename T> __device__ __forceinline__ float round_dt(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// the vector gate sigmoid(x): rounded to the data type in the km2 form
template <typename T, bool KM> __device__ __forceinline__ float gate(float x) {
  return KM ? round_dt<T>(sigmoid_f(x)) : sigmoid_f(x);
}

struct Dims {
  int hs, hv, k, g, rows, rows_p;  // rows = g*k, rows_p = rows rounded to kRowTile
  int s1, v1, c0, f;               // 2hs+1, 2hv, hs+hv, hs+3hv
};

__host__ __device__ inline long weight_floats(const Dims& d) {
  return (long)(d.s1 + d.v1) * d.c0 + (long)d.s1 * d.hv + (long)d.v1 * d.hv +
         (long)d.c0 * d.c0 + (long)d.hs * d.hv + (long)d.hv * d.hv;
}

// X0 (s1+v1) + XS (s1) + XV (3 v1) + O0 (c0) + OA (hv) + OB (3 hv) + geo (5)
__host__ __device__ inline long row_floats(const Dims& d) {
  return (long)(d.s1 + d.v1) + d.s1 + 3L * d.v1 + d.c0 + d.hv + 3L * d.hv + 5;
}

__host__ __device__ inline long smem_bytes(const Dims& d) {
  return sizeof(float) * (weight_floats(d) + row_floats(d) * d.rows_p) +
         sizeof(int) * d.rows_p;
}

// G receivers a group: 48 slot rows at most, fewer where a wide layer's
// rows would not fit shared memory beside its weights
__host__ __device__ inline Dims make_dims(int hs, int hv, int k) {
  Dims d;
  d.hs = hs; d.hv = hv; d.k = k;
  d.s1 = 2 * hs + 1; d.v1 = 2 * hv; d.c0 = hs + hv; d.f = hs + 3 * hv;
  for (d.g = k >= kTargetRows ? 1 : kTargetRows / k;; --d.g) {
    d.rows = d.g * k;
    d.rows_p = (d.rows + kRowTile - 1) / kRowTile * kRowTile;
    if (d.g == 1 || smem_bytes(d) <= gmma::kMaxSmem) return d;
  }
}

// Y[r][j] = sum_i X[r][i] W[i][j] for r < nrows (a multiple of kRowTile)
__device__ __forceinline__ void smem_gemm(const float* __restrict__ X, int nrows, int kdim,
                                          const float* __restrict__ W, int ncols,
                                          float* __restrict__ Y) {
  const int nwork = (nrows / kRowTile) * ncols;
  for (int w = threadIdx.x; w < nwork; w += blockDim.x) {
    const int j = w % ncols;
    const int r0 = (w / ncols) * kRowTile;
    const float* x = X + (long)r0 * kdim;
    float acc[kRowTile];
#pragma unroll
    for (int t = 0; t < kRowTile; ++t) acc[t] = 0.0f;
    for (int i = 0; i < kdim; ++i) {
      const float wv = W[i * ncols + j];
#pragma unroll
      for (int t = 0; t < kRowTile; ++t) acc[t] = fmaf(x[t * kdim + i], wv, acc[t]);
    }
#pragma unroll
    for (int t = 0; t < kRowTile; ++t) Y[(long)(r0 + t) * ncols + j] = acc[t];
  }
}

// KM: h is hr [N, F]; the sender rows come from hsp = hs3 [K, N, F] (row
// k*N + i) and the geometry from geo2 [N, K*6]; d2, attr, maskf, loc, gtab
// are unused.  FLAT: h is hr [N, F]; the sender rows come from hsp = hs
// [N*K, F] (row i*K + k); loc, gtab, geo2 are unused; pack is the K-sum's
// group size (1 for the others).
template <typename T, Addr A>
__global__ void __launch_bounds__(kThreads)
fused_message_tab_fwd_kernel(const T* __restrict__ h, const T* __restrict__ d2,
                             const T* __restrict__ attr, const T* __restrict__ maskf,
                             const int* __restrict__ loc, const int* __restrict__ gtab,
                             const T* __restrict__ hsp, const T* __restrict__ geo2,
                             const T* __restrict__ w0a, const T* __restrict__ w1sa,
                             const T* __restrict__ w1va, const T* __restrict__ w0b,
                             const T* __restrict__ w1sb, const T* __restrict__ w1vb,
                             T* __restrict__ out, int npad, int hs, int hv, int k,
                             int tile, int u, int pack) {
  constexpr bool KM = A == Addr::kKm;
  const Dims d = make_dims(hs, hv, k);
  extern __shared__ float smem[];
  // weights
  float* W0a = smem;
  float* W1Sa = W0a + (d.s1 + d.v1) * d.c0;
  float* W1Va = W1Sa + d.s1 * d.hv;
  float* W0b = W1Va + d.v1 * d.hv;
  float* W1Sb = W0b + d.c0 * d.c0;
  float* W1Vb = W1Sb + d.hs * d.hv;
  // per-row buffers
  float* X0 = W1Vb + d.hv * d.hv;             // [rows_p][s1+v1] (layer 2: [rows_p][c0])
  float* XS = X0 + d.rows_p * (d.s1 + d.v1);  // [rows_p][s1]    (layer 2: [rows_p][hs])
  float* XV = XS + d.rows_p * d.s1;           // [rows_p*3][v1]  (layer 2: [rows_p*3][hv])
  float* O0 = XV + d.rows_p * 3 * d.v1;       // [rows_p][c0]
  float* OA = O0 + d.rows_p * d.c0;           // [rows_p][hv]
  float* OB = OA + d.rows_p * d.hv;           // [rows_p*3][hv]
  float* GEO = OB + d.rows_p * 3 * d.hv;      // [rows_p][5]: s, vx, vy, vz, mask
  // [rows_p] the sender's row in hsrc (h by the table, or hsp), or -1
  int* SND = reinterpret_cast<int*>(GEO + d.rows_p * 5);
  const T* __restrict__ hsrc = A == Addr::kTab ? h : hsp;
  // the dot lanes of f0: scaled by CG110 here, or (KM) in the staged weights
  const float cg_dot = KM ? 1.0f : kCG110;

  {
    const T* src[6] = {w0a, w1sa, w1va, w0b, w1sb, w1vb};
    float* dst[6] = {W0a, W1Sa, W1Va, W0b, W1Sb, W1Vb};
    const int len[6] = {(d.s1 + d.v1) * d.c0, d.s1 * d.hv, d.v1 * d.hv,
                        d.c0 * d.c0, d.hs * d.hv, d.hv * d.hv};
    // KM: the vector rows of W0 (from row s1, resp. hs) times CG110, both
    // in the data type, as the km2 form folds them (w0v of _km2_mats)
    const float cg_t = round_dt<T>(kCG110);
    const int vrow[6] = {d.s1, 1 << 30, 1 << 30, d.hs, 1 << 30, 1 << 30};
    for (int m = 0; m < 6; ++m)
      for (int i = threadIdx.x; i < len[m]; i += blockDim.x) {
        const float x = to_f(src[m][i]);
        dst[m][i] = (KM && i / d.c0 >= vrow[m]) ? round_dt<T>(cg_t * x) : x;
      }
  }

  const int f = d.f;
  const int ngroups = (npad + d.g - 1) / d.g;
  for (int grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
    const int node0 = grp * d.g;
    // ---- per-row sender id and geometry
    for (int r = threadIdx.x; r < d.rows_p; r += blockDim.x) {
      const int node = node0 + r / d.k;
      int snd = -1;
      float g5[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < d.rows && node < npad) {
        const long e = (long)node * d.k + r % d.k;
        if (KM) {
          snd = (r % d.k) * npad + node;  // K*N < 2^31, checked by the wrapper
          const T* g = geo2 + e * 6;      // sh 4, d2, mask
#pragma unroll
          for (int q = 0; q < 4; ++q) g5[q] = to_f(g[q]);
          g5[4] = to_f(g[5]);
          XS[r * d.s1 + 2 * d.hs] = to_f(g[4]);
        } else {
          if (A == Addr::kFlat) {
            snd = (int)e;  // N*K < 2^31, checked by the wrapper
          } else {
            const int l = loc[e];
            if (l < u) {
              const int t = gtab[(long)(node / tile) * u + l];
              snd = (t >= 0 && t < npad) ? t : -1;
            }
          }
          g5[0] = to_f(attr[e * 4 + 0]);
          g5[1] = to_f(attr[e * 4 + 1]);
          g5[2] = to_f(attr[e * 4 + 2]);
          g5[3] = to_f(attr[e * 4 + 3]);
          g5[4] = to_f(maskf[e]);
          XS[r * d.s1 + 2 * d.hs] = to_f(d2[e]);
        }
      } else {
        XS[r * d.s1 + 2 * d.hs] = 0.f;
      }
      SND[r] = snd;
#pragma unroll
      for (int q = 0; q < 5; ++q) GEO[r * 5 + q] = g5[q];
    }
    __syncthreads();

    // ---- layer-1 inputs: xs = [hs0e || hr0e || d2], xv_c = [hs_c || hr_c]
    {
      const int width = 2 * d.hs + d.v1;  // xs without d2, then the vector lanes
      for (int w = threadIdx.x; w < d.rows_p * width; w += blockDim.x) {
        const int r = w / width, j = w % width;
        const int node = node0 + r / d.k;
        const bool live = r < d.rows && node < npad;
        const int snd = SND[r];
        const float s = GEO[r * 5 + 0];
        if (j < 2 * d.hs) {
          float x = 0.f;
          if (j < d.hs) {
            if (snd >= 0) x = to_f(hsrc[(long)snd * f + j]);
          } else if (live) {
            x = to_f(h[(long)node * f + (j - d.hs)]);
          }
          XS[r * d.s1 + j] = x;
          X0[r * (d.s1 + d.v1) + j] = x * s;
        } else {
          const int jj = j - 2 * d.hs;  // lane in [0, v1)
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            float x = 0.f;
            if (jj < d.hv) {
              if (snd >= 0) x = to_f(hsrc[(long)snd * f + d.hs + c * d.hv + jj]);
            } else if (live) {
              x = to_f(h[(long)node * f + d.hs + c * d.hv + (jj - d.hv)]);
            }
            XV[(r * 3 + c) * d.v1 + jj] = x * s;
            dot = fmaf(x, GEO[r * 5 + 1 + c], dot);
          }
          X0[r * (d.s1 + d.v1) + d.s1 + jj] = cg_dot * dot;
        }
      }
      // the d2 lane of f0
      for (int r = threadIdx.x; r < d.rows_p; r += blockDim.x)
        X0[r * (d.s1 + d.v1) + 2 * d.hs] = XS[r * d.s1 + 2 * d.hs] * GEO[r * 5];
    }
    __syncthreads();

    // ---- layer-1 products
    smem_gemm(X0, d.rows_p, d.s1 + d.v1, W0a, d.c0, O0);
    smem_gemm(XS, d.rows_p, d.s1, W1Sa, d.hv, OA);
    smem_gemm(XV, 3 * d.rows_p, d.v1, W1Va, d.hv, OB);
    __syncthreads();

    // ---- layer-1 gates, rounded to the data type -> layer-2 inputs
    for (int w = threadIdx.x; w < d.rows_p * d.c0; w += blockDim.x) {
      const int r = w / d.c0, j = w % d.c0;
      const float s = GEO[r * 5 + 0];
      if (j < d.hs) {
        const float o = O0[r * d.c0 + j];
        const float m0 = round_dt<T>(o * sigmoid_f(o));
        XS[r * d.hs + j] = m0;
        X0[r * d.c0 + j] = m0 * s;
      } else {
        const int jj = j - d.hs;
        const float g = gate<T, KM>(O0[r * d.c0 + j]);
        const float a = KM ? round_dt<T>(OA[r * d.hv + jj]) : OA[r * d.hv + jj];
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float v = GEO[r * 5 + 1 + c];
          const float m1 = round_dt<T>(kCG011 * fmaf(v, a, OB[(r * 3 + c) * d.hv + jj]) * g);
          XV[(r * 3 + c) * d.hv + jj] = m1 * s;
          dot = fmaf(m1, v, dot);
        }
        X0[r * d.c0 + j] = cg_dot * dot;
      }
    }
    __syncthreads();

    // ---- layer-2 products
    smem_gemm(X0, d.rows_p, d.c0, W0b, d.c0, O0);
    smem_gemm(XS, d.rows_p, d.hs, W1Sb, d.hv, OA);
    smem_gemm(XV, 3 * d.rows_p, d.hv, W1Vb, d.hv, OB);
    __syncthreads();

    // ---- layer-2 gates, mask, per-slot rounding, fp32 sum over K (FLAT:
    //      per-group rounding of the fp32 sum of pack slots)
    for (int w = threadIdx.x; w < d.g * f; w += blockDim.x) {
      const int i = w / f, col = w % f;
      const int node = node0 + i;
      if (node >= npad) continue;
      float acc = 0.f, gsum = 0.f;
      for (int kk = 0; kk < d.k; ++kk) {
        const int r = i * d.k + kk;
        const float mk = GEO[r * 5 + 4];
        if (mk != 0.f) {  // a masked or padding slot contributes 0
          float m;
          if (col < d.hs) {
            const float o = O0[r * d.c0 + col];
            m = o * sigmoid_f(o);
          } else {
            const int c = (col - d.hs) / d.hv, jj = (col - d.hs) % d.hv;
            const float g = gate<T, KM>(O0[r * d.c0 + d.hs + jj]);
            const float a = KM ? round_dt<T>(OA[r * d.hv + jj]) : OA[r * d.hv + jj];
            m = kCG011 * fmaf(GEO[r * 5 + 1 + c], a, OB[(r * 3 + c) * d.hv + jj]) * g;
          }
          if (A == Addr::kFlat) gsum += m * mk;
          else acc += round_dt<T>(m * mk);
        }
        if (A == Addr::kFlat && (kk + 1) % pack == 0) {
          acc += round_dt<T>(gsum);
          gsum = 0.f;
        }
      }
      out[(long)node * f + col] = from_f<T>(acc);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core engine (lmax1_mma.cuh).  A warp walks its units (G
// receivers each: units u = blockIdx.x * kWarps + warp, then every
// gridDim.x * kWarps), each as T tiles of 16 slot rows; tile it + 1 is
// gathered into the other buffer while tile it multiplies.
namespace mma {

// the engine's names (declared here, so that they hide the FMA kernel's)
using l1mma::align16; using l1mma::bf16; using l1mma::buf_bytes; using l1mma::Buf;
using l1mma::carve_buf; using l1mma::copy_mode; using l1mma::cp_async_commit;
using l1mma::cp_async_wait;
using l1mma::fits; using l1mma::gate1; using l1mma::gather_tile; using l1mma::GatherArgs;
using l1mma::kCG;
using l1mma::kHS; using l1mma::kHV; using l1mma::kLdK; using l1mma::kLdW; using l1mma::KSum;
using l1mma::ksum_init; using l1mma::ksum_tile;
using l1mma::kWRows; using l1mma::layer1; using l1mma::layer2; using l1mma::rnd;
using l1mma::row_geo; using l1mma::RowGeo; using l1mma::sigm; using l1mma::stage_weights;
using l1mma::TileRef; using l1mma::unit_recv; using l1mma::unit_tiles;
using l1mma::weight_bytes;

constexpr int kWarps = 4;  // a block; three blocks share an SM
constexpr int kThreads = 32 * kWarps;

// shared memory: the weights, then per warp two gather buffers and a K-sum
// buffer [16][kLdK] fp32
__host__ inline long smem_bytes(int k) {
  return weight_bytes() + kWarps * (2 * buf_bytes(k, false) + align16(4L * 16 * kLdK));
}

template <Addr A>
__global__ void __launch_bounds__(kThreads)
fused_message_fwd_mma(GatherArgs ga, const bf16* __restrict__ w0a, const bf16* __restrict__ w1sa,
                      const bf16* __restrict__ w1va, const bf16* __restrict__ w0b,
                      const bf16* __restrict__ w1sb, const bf16* __restrict__ w1vb,
                      bf16* __restrict__ out, int pack) {
  constexpr bool KM = A == Addr::kKm, FLAT = A == Addr::kFlat;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* W = reinterpret_cast<bf16*>(smem_raw);
  float* d2w = reinterpret_cast<float*>(smem_raw + align16(2L * kWRows * kLdW));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k = ga.k;
  const long bb = buf_bytes(k, false);
  unsigned char* wp = smem_raw + weight_bytes() + warp * (2 * bb + align16(4L * 16 * kLdK));
  float* kbuf = reinterpret_cast<float*>(wp + 2 * bb);
  // the padded lanes of both buffers stay zero
  for (long x = lane; x < 2 * bb / 16; x += 32)
    reinterpret_cast<uint4*>(wp)[x] = make_uint4(0u, 0u, 0u, 0u);
  stage_weights<KM>(l1mma::Bench(), W, d2w, w0a, w1sa, w1va, w0b, w1sb, w1vb, ga.hs, ga.hv);
  __syncthreads();

  // (npad K < 2^31, checked by the wrapper: int arithmetic throughout)
  const int G = unit_recv(k, 0), T = unit_tiles(k, 0);
  const int units = (ga.npad + G - 1) / G;
  const int first = blockIdx.x * kWarps + warp, stride = gridDim.x * kWarps;
  const int nit = first < units ? (units - first + stride - 1) / stride * T : 0;
  auto ref = [&](int it) {
    const int un = first + it / T * stride;
    TileRef tr;
    tr.node0 = un * G;
    tr.nrecv = ga.npad - tr.node0 < G ? ga.npad - tr.node0 : G;
    tr.q0 = it % T * 16;
    tr.slot0 = 0;
    return tr;
  };
  const float cgd = KM ? 1.0f : kCG;
  KSum ks;
  ksum_init(ks);
  if (nit > 0) {
    gather_tile<A>(carve_buf(wp, k, false), ref(0), ga, lane);
    cp_async_commit();
  }
  for (int it = 0; it < nit; ++it) {
    if (it + 1 < nit) {
      gather_tile<A>(carve_buf(wp + ((it + 1) & 1) * bb, k, false), ref(it + 1), ga, lane);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const Buf b = carve_buf(wp + (it & 1) * bb, k, false);
    const TileRef tr = ref(it);
    const RowGeo rg = row_geo(b.geo, g);
    float o0[6][4], oa[2][4], ob[3][2][4];
    layer1(W, d2w, b, rg, cgd, lane, o0, oa, ob);
    uint32_t am0[2][4], am1[3][4];
    gate1<KM>(o0, oa, ob, rg, am0, am1);
    layer2(W, rg, cgd, lane, am0, am1, o0, oa, ob);
    // the layer-2 gates and the mask: each slot's message (TAB, KM rounded
    // to bf16; FLAT in fp32, rounded per group in the K-sum)
    auto msg = [&](float m, int h) {
      const float mk = rg.mk(h);
      return mk != 0.f ? (FLAT ? m * mk : rnd(m * mk)) : 0.f;
    };
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = kbuf + (g + 8 * h) * kLdK + 2 * t4;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float x0 = o0[nt][2 * h], x1 = o0[nt][2 * h + 1];
        *reinterpret_cast<float2*>(row + nt * 8) =
            make_float2(msg(x0 * sigm(x0), h), msg(x1 * sigm(x1), h));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float m[3][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int q = 2 * h + j;
          const float gt = KM ? rnd(sigm(o0[4 + i][q])) : sigm(o0[4 + i][q]);
          const float a = KM ? rnd(oa[i][q]) : oa[i][q];
#pragma unroll
          for (int c = 0; c < 3; ++c) m[c][j] = msg(kCG * fmaf(rg.v(h, c), a, ob[c][i][q]) * gt, h);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c)
          *reinterpret_cast<float2*>(row + kHS + kHV * c + 8 * i) = make_float2(m[c][0], m[c][1]);
      }
    }
    __syncwarp();
    ksum_tile<FLAT>(ks, kbuf, tr, k, pack, ga.hs, ga.hv, out, lane);
    __syncwarp();
  }
}

template <Addr A>
int launch(const GatherArgs& ga, const void* const* w, void* out, int pack, cudaStream_t stream) {
  if (!fits(ga.hs, ga.hv) || pack < 1 || ga.k % pack != 0) return (int)cudaErrorInvalidValue;
  const long smem = smem_bytes(ga.k);
  auto kern = fused_message_fwd_mma<A>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int G = unit_recv(ga.k, 0);
  const long units = (ga.npad + G - 1) / G;
  long grid = (long)sms * per_sm;
  if (grid > (units + kWarps - 1) / kWarps) grid = (units + kWarps - 1) / kWarps;
  if (grid < 1) grid = 1;
  auto wt = [w](int i) { return static_cast<const bf16*>(w[i]); };
  kern<<<(int)grid, kThreads, smem, stream>>>(ga, wt(0), wt(1), wt(2), wt(3), wt(4), wt(5),
                                              static_cast<bf16*>(out), pack);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 past 32x0e+16x1o: the Wide kernel, instance M (lmax1_mma.cuh: "The
// Wide kernels").  The same walk over units and tiles; layer 1 on the
// gathered rows and its gates into layer 2's A fragments (registers), layer 2
// a column block at a time, the weights of each block through the block's
// ring; the layer-2 messages go into the K-sum buffer [16][ldk] (bf16 for TAB
// and KM: each of their slot messages is rounded to bf16 before its fp32
// K-sum; fp32 for FLAT, whose p messages of a group are summed before they
// round).  A block's warps walk the same number of tiles (a warp past its
// units walks empty ones: every warp takes every chunk), as many warps as
// shared memory holds beside the ring (at most kWideWarps).
using l1mma::ChunkLane; using l1mma::chunk_lane; using l1mma::KSumN;
using l1mma::l2_sblk; using l1mma::l2_vblk; using l1mma::layer1_wide; using l1mma::wide_m;
using l1mma::WidePack; using l1mma::WideS; using l1mma::WRing;

constexpr int kWideWarps = 8;

template <Addr A, int M> struct FwdWide {
  typedef WRing<M, false> Ring;
  typedef typename std::conditional<A == Addr::kFlat, float, bf16>::type KT;
  static constexpr int kLdF = 80 * M + 8, kLdK = 80 * M + 8;
  static constexpr int kCols = (80 * M + 31) / 32;  // the K-sum's columns a lane
  // per warp: two gather buffers and the K-sum buffer
  __host__ __device__ static long warp_bytes(int k) {
    return 2 * buf_bytes(WideS<M>(), k, false) + align16((long)sizeof(KT) * 16 * kLdK);
  }
  // the ring, then d2w [n] fp32
  __host__ __device__ static constexpr long fixed_bytes() {
    return (Ring::kBytes + 15) / 16 * 16 + 4L * 64 * M;
  }
  __host__ __device__ static long smem_bytes(int k, int warps) {
    return fixed_bytes() + warps * warp_bytes(k);
  }
  __host__ static int warps(int k) {
    int w = kWideWarps;
    while (w > 0 && smem_bytes(k, w) > gmma::kMaxSmem) --w;
    return w;
  }
};

__device__ __forceinline__ void put2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void put2(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

template <Addr A, int M>
__global__ void __launch_bounds__(32 * kWideWarps, 1)
fused_message_fwd_wide_mma(GatherArgs ga, const unsigned char* __restrict__ wpk,
                           bf16* __restrict__ out, int pack) {
  constexpr bool KM = A == Addr::kKm, FLAT = A == Addr::kFlat;
  typedef FwdWide<A, M> F;
  typedef typename F::KT KT;
  constexpr int HSP = 32 * M, HVP = 16 * M, LDF = F::kLdF, LDK = F::kLdK;
  const WideS<M> sh{};
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int k = ga.k;
  float* d2w = reinterpret_cast<float*>(smem_raw + (F::Ring::kBytes + 15) / 16 * 16);
  const long bb = buf_bytes(sh, k, false);
  unsigned char* wp = smem_raw + F::fixed_bytes() + warp * F::warp_bytes(k);
  KT* kbuf = reinterpret_cast<KT*>(wp + 2 * bb);
  // the padded lanes of both buffers stay zero
  for (long x = lane; x < 2 * bb / 16; x += 32)
    reinterpret_cast<uint4*>(wp)[x] = make_uint4(0u, 0u, 0u, 0u);
  for (int c = threadIdx.x; c < 64 * M; c += blockDim.x)
    d2w[c] = reinterpret_cast<const float*>(wpk + WidePack<M>::D2W_OFF)[c];

  // (npad K < 2^31, checked by the wrapper: int arithmetic throughout)
  const int G = unit_recv(k, 0), T = unit_tiles(k, 0);
  const int units = (ga.npad + G - 1) / G;
  const int first = blockIdx.x * warps + warp, stride = gridDim.x * warps;
  const int first0 = blockIdx.x * warps;  // warp 0's first unit: warp 0 has the most
  const int nit = first0 < units ? (units - first0 + stride - 1) / stride * T : 0;
  typename F::Ring ring;
  ring.setup(smem_raw, wpk, nit * F::Ring::kPerTile, warps);
  ring.start();  // (its block barrier also orders d2w and the zeroed buffers)
  auto ref = [&](int it) {
    const int un = first + it / T * stride;
    TileRef tr;
    tr.node0 = un * G;
    tr.nrecv = un < units ? (ga.npad - tr.node0 < G ? ga.npad - tr.node0 : G) : 0;
    tr.q0 = it % T * 16;
    tr.slot0 = 0;
    return tr;
  };
  const float cgd = KM ? 1.0f : kCG;
  const ChunkLane cl = chunk_lane(lane);
  KSumN<F::kCols> ks;
  ksum_init(ks);
  if (nit > 0) {
    gather_tile<A>(carve_buf(sh, wp, k, false), ref(0), ga, lane, sh);
    cp_async_commit();
  }
  for (int it = 0; it < nit; ++it) {
    if (it + 1 < nit) {
      gather_tile<A>(carve_buf(sh, wp + ((it + 1) & 1) * bb, k, false), ref(it + 1), ga, lane, sh);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const Buf b = carve_buf(sh, wp + (it & 1) * bb, k, false);
    const TileRef tr = ref(it);
    const RowGeo rg = row_geo(b.geo, g);
    const int ar = lane & 15, ac = (lane >> 4) * 8;
    const int q = it * F::Ring::kPerTile;
    // ---- layer 1 and its gates: layer 2's A fragments
    uint32_t am0[2 * M][4], am1[M][3][4];
    layer1_wide<M, KM>(ring, q, lane, cl, b.s + ar * LDF + ac, b.r + b.ri[ar] * LDF + ac, d2w,
                       rg, cgd, am0, am1);
    // ---- layer 2, its gates and the mask: each slot's message (TAB, KM
    //      rounded to bf16; FLAT in fp32, rounded per group in the K-sum)
    auto msg = [&](float m, int h) {
      const float mk = rg.mk(h);
      return mk != 0.f ? (FLAT ? m * mk : rnd(m * mk)) : 0.f;
    };
#pragma unroll
    for (int cb = 0; cb < M; ++cb) {
      float o[4][4];
      l2_sblk<M>(ring, q + 4 * M + cb, lane, cl, am0, am1, rg, cgd, o);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        KT* row = kbuf + (g + 8 * h) * LDK + 32 * cb + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float x0 = o[nt][2 * h], x1 = o[nt][2 * h + 1];
          put2(row + nt * 8, msg(x0 * sigm(x0), h), msg(x1 * sigm(x1), h));
        }
      }
    }
#pragma unroll
    for (int v = 0; v < M; ++v) {
      float og[2][4], oa[2][4], ob[3][2][4];
      l2_vblk<M>(ring, q + 5 * M + v, lane, cl, am0, am1, rg, cgd, v, og, oa, ob);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        KT* row = kbuf + (g + 8 * h) * LDK + HSP + 16 * v + 2 * t4;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float m[3][2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int qq = 2 * h + j;
            const float gt = KM ? rnd(sigm(og[i][qq])) : sigm(og[i][qq]);
            const float a = KM ? rnd(oa[i][qq]) : oa[i][qq];
#pragma unroll
            for (int c = 0; c < 3; ++c)
              m[c][j] = msg(kCG * fmaf(rg.v(h, c), a, ob[c][i][qq]) * gt, h);
          }
#pragma unroll
          for (int c = 0; c < 3; ++c) put2(row + HVP * c + 8 * i, m[c][0], m[c][1]);
        }
      }
    }
    __syncwarp();
    ksum_tile<FLAT>(ks, kbuf, tr, k, pack, ga.hs, ga.hv, out, lane, sh);
    __syncwarp();
  }
}

// The launch of instance M: the packed weights into scratch, then the kernel
template <Addr A, int M>
int launch_wide_m(const GatherArgs& ga, const void* const* w, void* out, void* scratch, int pack,
                  cudaStream_t stream) {
  typedef FwdWide<A, M> F;
  const int warps = F::warps(ga.k);
  if (warps < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  const long smem = F::smem_bytes(ga.k, warps);
  auto kern = fused_message_fwd_wide_mma<A, M>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 32 * warps, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int G = unit_recv(ga.k, 0);
  const long units = (ga.npad + G - 1) / G;
  long grid = (long)sms * per_sm;
  if (grid > (units + warps - 1) / warps) grid = (units + warps - 1) / warps;
  if (grid < 1) grid = 1;
  auto wt = [w](int i) { return static_cast<const bf16*>(w[i]); };
  l1mma::lmax1_wide_pack<A == Addr::kKm, M><<<sms, 256, 0, stream>>>(
      static_cast<unsigned char*>(scratch), wt(0), wt(1), wt(2), wt(3), wt(4), wt(5), ga.hs, ga.hv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kern<<<(int)grid, 32 * warps, smem, stream>>>(ga, static_cast<const unsigned char*>(scratch),
                                                static_cast<bf16*>(out), pack);
  return (int)cudaGetLastError();
}

template <Addr A>
int launch_wide(const GatherArgs& ga, const void* const* w, void* out, void* scratch, int pack,
                cudaStream_t stream) {
  if (ga.hs < 1 || ga.hv < 0 || pack < 1 || ga.k % pack != 0) return (int)cudaErrorInvalidValue;
#define CALL(m) return launch_wide_m<A, m>(ga, w, out, scratch, pack, stream)
  switch (wide_m(ga.hs, ga.hv)) { LMAX1_WIDE_CASES(CALL) }
#undef CALL
  return (int)cudaErrorInvalidValue;
}

// shared memory a block of the Wide kernel's instance M takes, its warps and
// its blocks an SM (the occupancy query)
template <Addr A, int M>
long wide_config_m(int k, int* warps_out, int* per_sm_out) {
  typedef FwdWide<A, M> F;
  const int warps = F::warps(k);
  const long smem = F::smem_bytes(k, warps > 0 ? warps : 1);
  if (warps_out != nullptr) *warps_out = warps;
  if (per_sm_out != nullptr) {
    *per_sm_out = 0;
    auto kern = fused_message_fwd_wide_mma<A, M>;
    if (warps > 0 &&
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) ==
            cudaSuccess)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm_out, kern, 32 * warps, smem);
  }
  return smem;
}
// ... at these widths (-1: no instance)
template <Addr A>
long wide_config(int hs, int hv, int k, int* warps_out, int* per_sm_out) {
#define CALL(m) return wide_config_m<A, m>(k, warps_out, per_sm_out)
  switch (wide_m(hs, hv)) { LMAX1_WIDE_CASES(CALL) }
#undef CALL
  return -1;
}

inline GatherArgs gather_args(const void* h, const void* hsp, const void* d2, const void* attr,
                              const void* maskf, const void* loc, const void* gtab,
                              const void* geo2, int npad, int hs, int hv, int k, int tile, int u) {
  GatherArgs ga;
  ga.h = static_cast<const bf16*>(h);
  ga.hsp = static_cast<const bf16*>(hsp);
  ga.d2 = static_cast<const bf16*>(d2);
  ga.attr = static_cast<const bf16*>(attr);
  ga.maskf = static_cast<const bf16*>(maskf);
  ga.loc = static_cast<const int*>(loc);
  ga.gtab = static_cast<const int*>(gtab);
  ga.geo2 = static_cast<const bf16*>(geo2);
  ga.dagg = nullptr;
  ga.npad = npad; ga.hs = hs; ga.hv = hv; ga.k = k; ga.tile = tile; ga.u = u;
  ga.mode = copy_mode(hs, hv, {h, hsp});
  return ga;
}

}  // namespace mma

// fp32: the FMA kernel
template <Addr A>
int launch_fma(const void* h, const void* d2, const void* attr, const void* maskf,
               const int* loc, const int* gtab, const void* hsp, const void* geo2,
               const void* w0a, const void* w1sa, const void* w1va, const void* w0b,
               const void* w1sb, const void* w1vb, void* out, int npad, int hs, int hv, int k,
               int tile, int u, int pack, cudaStream_t stream) {
  typedef float T;
  const Dims d = make_dims(hs, hv, k);
  const long smem = smem_bytes(d);
  if (pack < 1 || k % pack != 0 || smem > gmma::kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = fused_message_tab_fwd_kernel<T, A>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int ngroups = (npad + d.g - 1) / d.g;
  int grid = sms * per_sm;
  if (grid > ngroups) grid = ngroups;
  if (grid < 1) grid = 1;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(d2), static_cast<const T*>(attr),
      static_cast<const T*>(maskf), loc, gtab, static_cast<const T*>(hsp),
      static_cast<const T*>(geo2), static_cast<const T*>(w0a),
      static_cast<const T*>(w1sa), static_cast<const T*>(w1va), static_cast<const T*>(w0b),
      static_cast<const T*>(w1sb), static_cast<const T*>(w1vb), static_cast<T*>(out), npad,
      hs, hv, k, tile, u, pack);
  return (int)cudaGetLastError();
}

// The library's launch of a dtype: built plain, fp32 on the FMA kernel and
// bf16 on the Bench kernel (up to 32x0e+16x1o); built with LMAX1_WIDE=1 and
// LMAX1_WIDE_M=m (a library of this source for each instance, compiled
// beside the first), bf16 on the Wide kernel's instance m (scratch: the packed weights, of
// fused_message_fwd_scratch_bytes).  The wrapper picks the library by the
// widths.
template <Addr A>
int launch_dtype(int dtype, const void* h, const void* hsp, const void* d2, const void* attr,
                 const void* maskf, const void* loc, const void* gtab, const void* geo2,
                 const void* const* w, void* out, void* scratch, int npad, int hs, int hv, int k,
                 int tile, int u, int pack, cudaStream_t st) {
  if constexpr (kWideLibrary) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return mma::launch_wide<A>(
        mma::gather_args(h, hsp, d2, attr, maskf, loc, gtab, geo2, npad, hs, hv, k, tile, u), w,
        out, scratch, pack, st);
  } else {
    if (dtype == 0)
      return launch_fma<A>(h, d2, attr, maskf, static_cast<const int*>(loc),
                           static_cast<const int*>(gtab), hsp, geo2, w[0], w[1], w[2], w[3], w[4],
                           w[5], out, npad, hs, hv, k, tile, u, pack, st);
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return mma::launch<A>(
        mma::gather_args(h, hsp, d2, attr, maskf, loc, gtab, geo2, npad, hs, hv, k, tile, u), w,
        out, pack, st);
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for these widths (bytes; dtype 0 = float32,
// 1 = bfloat16) in this library; the wrapper checks it against the card's
// limit before launching.  (The Wide kernels: their tabled instance's; past
// the largest instance, one past the limit.)
long fused_message_tab_fwd_smem_bytes(int dtype, int hs, int hv, int k) {
  if (dtype == 0) return smem_bytes(make_dims(hs, hv, k));
#if LMAX1_WIDE
  const long smem = mma::wide_config<Addr::kTab>(hs, hv, k, nullptr, nullptr);
  return smem < 0 ? gmma::kMaxSmem + 1 : smem;
#else
  return mma::smem_bytes(k);
#endif
}

// Bytes of the scratch buffer a launch of this library takes (the Wide
// kernels' packed weights; 0: none)
long fused_message_fwd_scratch_bytes(int dtype, int hs, int hv) {
  if (!kWideLibrary || dtype != 1) return 0;
  switch (l1mma::wide_m(hs, hv)) {
#define CALL(m) return l1mma::WidePack<m>::BYTES
    LMAX1_WIDE_CASES(CALL)
#undef CALL
  }
  return 0;
}

// The Wide kernel of an addressing (0 tabled, 1 km, 2 flat) at these widths:
// out[0] its warps a block, out[1] its blocks an SM (the occupancy query);
// returns its shared memory a block (bytes), or -1 (no instance, or not the
// Wide library).
long lmax1_wide_fwd_config(int addr, int hs, int hv, int k, int* out) {
#if LMAX1_WIDE
  if (addr == 0) return mma::wide_config<Addr::kTab>(hs, hv, k, out, out + 1);
  if (addr == 1) return mma::wide_config<Addr::kKm>(hs, hv, k, out, out + 1);
  return mma::wide_config<Addr::kFlat>(hs, hv, k, out, out + 1);
#else
  return -1;
#endif
}

// dtype: 0 = float32, 1 = bfloat16; scratch: fused_message_fwd_scratch_bytes
// (null where 0).  Returns cudaGetLastError() after the launch (0 on success).
int fused_message_tab_fwd(int dtype, const void* h, const void* d2, const void* attr,
                          const void* maskf, const void* loc, const void* gtab,
                          const void* w0a, const void* w1sa, const void* w1va,
                          const void* w0b, const void* w1sb, const void* w1vb, void* out,
                          void* scratch, int npad, int hs, int hv, int k, int tile, int u,
                          void* stream) {
  const void* w[6] = {w0a, w1sa, w1va, w0b, w1sb, w1vb};
  return launch_dtype<Addr::kTab>(dtype, h, nullptr, d2, attr, maskf, loc, gtab, nullptr, w, out,
                                  scratch, npad, hs, hv, k, tile, u, 1,
                                  static_cast<cudaStream_t>(stream));
}

// The untabled (km) forward: hs3 [K, N, F], hr [N, F], geo2 [N, K*6], the six
// weight blocks; out [N, F].  Returns cudaGetLastError() after the launch.
int fused_message_km_fwd(int dtype, const void* hs3, const void* hr, const void* geo2,
                         const void* w0a, const void* w1sa, const void* w1va,
                         const void* w0b, const void* w1sb, const void* w1vb, void* out,
                         void* scratch, int n, int hs, int hv, int k, void* stream) {
  const void* w[6] = {w0a, w1sa, w1va, w0b, w1sb, w1vb};
  return launch_dtype<Addr::kKm>(dtype, hr, hs3, nullptr, nullptr, nullptr, nullptr, nullptr,
                                 geo2, w, out, scratch, n, hs, hv, k, n, 0, 1,
                                 static_cast<cudaStream_t>(stream));
}

// The packed node-major forward (#6): hs [N*K, F] (the TPU's [N*K/p, p*F]),
// hr [N, F], d2 [N*K], attr [N*K, 4], maskf [N*K], the six weight blocks;
// out [N, F]; pack divides K.  Returns cudaGetLastError() after the launch.
int fused_message_flat_fwd(int dtype, const void* hs_rows, const void* hr, const void* d2,
                           const void* attr, const void* maskf, const void* w0a,
                           const void* w1sa, const void* w1va, const void* w0b,
                           const void* w1sb, const void* w1vb, void* out, void* scratch, int n,
                           int hs, int hv, int k, int pack, void* stream) {
  const void* w[6] = {w0a, w1sa, w1va, w0b, w1sb, w1vb};
  return launch_dtype<Addr::kFlat>(dtype, hr, hs_rows, d2, attr, maskf, nullptr, nullptr,
                                   nullptr, w, out, scratch, n, hs, hv, k, n, 0, pack,
                                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
