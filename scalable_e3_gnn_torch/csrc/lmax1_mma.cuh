// The lmax=1 message kernels' tensor-core engine (sm_90a, bf16), shared by
// fused_message_tab_fwd.cu (#1, #3, #6) and fused_message_tab_bwd.cu (#2, #5,
// #7): both gated L1 tensor-product layers of the SEGNN message MLP on
// mma.sync m16n8k16 with bf16 operands and fp32 accumulators.
//
// Exact operands.  Every operand of an mma is a bf16 value the TPU kernel
// also has: the gathered feature rows, the rounded layer-1 outputs and
// cotangents, the folded weights.  The per-row sh factors go onto the fp32
// accumulators where they factor out, (xs s) W = s (xs W); the dot lanes
// take sum_c v_c (xv_c W0v), three products of exact operands (the dot
// itself, a sum of three products, is not a bf16 value).  Where a factor
// does not factor out (the weight gradients' s d_o0 and s d_o1), the
// product of two bf16 values is split into hi + lo bf16 in registers, two
// mma, exactly the fp32 product; the weight gradients' dot lanes split the
// fp32 dot into three bf16 parts (hi + mid + lo: its 24 bits).  So the
// engine rounds where the TPU kernel rounds; its fp32 sums run in another
// order.
//
// Padded widths.  Scalars pad to multiples of 32 lanes and vectors to
// multiples of 16 a component (zero weights and zero inputs in the pads).
// Each layer's columns are [O0 (scalars | gates) | OA or OB]; a column block
// is either 32 scalar columns (silu) or 16 vector channels with their 16
// gate columns and 16 OA (or OB) columns, so that a channel's gate, A and
// B_c sit in one block.  At 32x0e+16x1o (the Bench shape, fixed at compile
// time) there is one block of each, [O0 (32 + 16) | OA (16)] = 64 columns,
// and the kernels hold a tile's whole layer in registers.  Wider layers run
// the Wide kernels (see "The Wide kernels" below): instances compiled for m
// scalar and m vector blocks, the layer-1 outputs passed to layer 2 in
// registers, the weights streamed through a ring of column-block chunks;
// each instance is a library of each source (built with LMAX1_WIDE=1 and
// LMAX1_WIDE_M=m).
//
// Shape of the work.  A warp owns 16-row mma tiles of slot rows and walks
// units of G whole receivers (G K rows rounded up to 16), so the K-sums run
// inside the warp: its lanes walk a tile's rows in slot order from a shared
// buffer, each lane three columns, keeping the running receiver sums in
// registers across the unit's tiles.  The Bench kernels' weights sit in
// shared memory once per block, bf16, row-major [in][out] (144 rows): ldmatrix.trans reads them
// as the forward's B fragments and plain ldmatrix as the VJP's (W^T), so no
// transposed copy is kept.  Each warp gathers its next tile's sender rows
// (through the table, or pre-gathered), receiver rows and geometry by
// cp.async into the other of two buffers while it multiplies the current one.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

#include "generic_mma.cuh"

namespace l1mma {

typedef __nv_bfloat16 bf16;
using gmma::cp_async16;
using gmma::cp_async4;
using gmma::cp_async_commit;
using gmma::cp_async_wait;
using gmma::ldsm_x2_t;
using gmma::ldsm_x4;
using gmma::ldsm_x4_t;
using gmma::mma_bf16_16816;

// where a slot's sender row and geometry come from (and, backward, where its
// sender cotangent goes)
enum class Addr {
  kTab,   // h[gtab[i / tile, loc[e]]]; d2, attr, maskf at e = i*K + k; d_hu by the table
  kKm,    // row k*N + i of hs3 [K, N, F] (and of d_hs); geo2 [N, K*6]
  kFlat,  // row e = i*K + k of hs [N*K, F] (and of d_hs); d2, attr, maskf at e
};

constexpr float kCG = 0.57735026918962576451f;  // CG110 = CG011 = 1/sqrt(3)
constexpr int kHS = 32, kHV = 16;   // the Bench shape's padded scalar / vector widths
constexpr int kC0 = kHS + kHV;      // 48: O0 columns
constexpr int kN = kC0 + kHV;       // 64: a layer GEMM's columns [O0 | OA or OB]
constexpr int kFP = kHS + 3 * kHV;  // 80: a padded feature row [s | v0 | v1 | v2]
constexpr int kChunks = kFP / 8;    // 16-byte chunks of a padded row
// row strides (elements) whose 16-byte count is odd: conflict-free ldmatrix
constexpr int kLdF = 88;  // feature rows
constexpr int kLdW = 72;  // weight rows
constexpr int kLdK = 88;  // K-sum rows
// the weight rows: [in][kN] per GEMM
constexpr int kW1s = 0;    // 64: sender scalars (32) | receiver scalars (32) -> [O0 | OA]
constexpr int kW1v = 64;   // 32: sender vector lanes (16) | receiver (16) -> [O0 dot | OB]
constexpr int kW2s = 96;   // 32: m0 -> [O0 | OA]
constexpr int kW2v = 128;  // 16: m1 -> [O0 dot | OB]
constexpr int kWRows = 144;
constexpr int kTargetRows = 48;  // slot rows per unit (G = max(1, 48 / K))

// ---------------------------------------------------------------------------
// The padded shapes: ns scalar blocks of 32 lanes, nv vector blocks of 16
// channels.  Bench fixes them at one each (the constants above); Wide counts
// them at run time.  Shape<B> derives every width, stride and weight row
// from them (at Bench each equals its constant above).
struct BenchBlocks {
  static constexpr int ns = 1, nv = 1;
};
struct WideBlocks {
  int ns, nv;
};

template <class B> struct Shape : B {
  __host__ __device__ constexpr int hsp() const { return 32 * this->ns; }  // padded scalars
  __host__ __device__ constexpr int hvp() const { return 16 * this->nv; }  // padded vectors
  __host__ __device__ constexpr int c0() const { return hsp() + hvp(); }   // O0 columns
  __host__ __device__ constexpr int n() const { return c0() + hvp(); }     // [O0 | OA or OB]
  __host__ __device__ constexpr int fp() const { return hsp() + 3 * hvp(); }  // [s | v0 | v1 | v2]
  __host__ __device__ constexpr int chunks() const { return fp() / 8; }
  // row strides (elements): 8 past a multiple of 16, an odd count of 16-byte
  // chunks (conflict-free ldmatrix)
  __host__ __device__ constexpr int ldf() const { return fp() + 8; }  // feature rows
  __host__ __device__ constexpr int ldw() const { return n() + 8; }   // weight rows
  __host__ __device__ constexpr int ldk() const { return fp() + 8; }  // K-sum rows
  // the weight rows: [in][n] per GEMM: layer 1's sender | receiver scalars,
  // its sender | receiver vector lanes, layer 2's m0, its m1
  __host__ __device__ constexpr int w1s() const { return 0; }
  __host__ __device__ constexpr int w1v() const { return 2 * hsp(); }
  __host__ __device__ constexpr int w2s() const { return 2 * hsp() + 2 * hvp(); }
  __host__ __device__ constexpr int w2v() const { return 3 * hsp() + 2 * hvp(); }
  __host__ __device__ constexpr int wrows() const { return 3 * hsp() + 3 * hvp(); }
};
typedef Shape<BenchBlocks> Bench;
typedef Shape<WideBlocks> Wide;

__host__ __device__ inline Wide wide_shape(int hs, int hv) {
  Wide s;
  s.ns = hs <= 32 ? 1 : (hs + 31) / 32;
  s.nv = hv <= 16 ? 1 : (hv + 15) / 16;
  return s;
}

// the widths the Bench kernels take
__host__ __device__ inline bool fits(int hs, int hv) {
  return hs >= 1 && hs <= kHS && hv >= 0 && hv <= kHV;
}
// receivers per unit and 16-row tiles per unit
__host__ __device__ inline int unit_recv(int k, int tile) {
  int g = k >= kTargetRows ? 1 : kTargetRows / k;
  if (tile > 0 && g > tile) g = tile;
  return g;
}
__host__ __device__ inline int unit_tiles(int k, int tile) {
  return (unit_recv(k, tile) * k + 15) / 16;
}
// receiver rows a 16-row tile can touch
__host__ __device__ inline int tile_recv(int k) { return (15 + k - 1) / k + 1; }

__host__ __device__ inline long align16(long b) { return (b + 15) / 16 * 16; }
template <class S> __host__ __device__ inline long weight_bytes(const S& sh) {
  return align16(2L * sh.wrows() * sh.ldw()) + align16(4L * sh.n());
}
__host__ __device__ inline long weight_bytes() { return weight_bytes(Bench()); }
// one warp's gather buffer: sender rows, receiver rows (and, backward,
// d_agg rows), geometry [16][8] fp32, receiver index [16], sender id [16]
template <class S> __host__ __device__ inline long buf_bytes(const S& sh, int k, bool dagg) {
  return align16(2L * 16 * sh.ldf()) + (dagg ? 2 : 1) * align16(2L * tile_recv(k) * sh.ldf()) +
         align16(4L * 16 * 8) + align16(4L * 16) + align16(4L * 16);
}
__host__ __device__ inline long buf_bytes(int k, bool dagg) { return buf_bytes(Bench(), k, dagg); }

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float bf(float x) { return x; }
__device__ __forceinline__ float rnd(float x) { return __bfloat162float(__float2bfloat16(x)); }
// the sigmoid (the FMA kernels' and the plain versions': the full-precision
// exponential, so that the bf16 roundings after it flip as rarely as the
// fp32 sum order lets them)
__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }
// two fp32 values as a bf16 pair (lo at the lower column)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// the padded column pc of a feature row -> the feature column, or -1
template <class S>
__device__ __forceinline__ int feat_col(const S& sh, int pc, int hs, int hv) {
  if (pc < sh.hsp()) return pc < hs ? pc : -1;
  const int c = (pc - sh.hsp()) / sh.hvp(), j = (pc - sh.hsp()) % sh.hvp();
  return c < 3 && j < hv ? hs + c * hv + j : -1;
}
// the padded output column of a layer (< n) -> O0 column (o) or OA/OB
// column (jj), the other -1
template <class S>
__device__ __forceinline__ void out_col(const S& sh, int col, int hs, int hv, int& o, int& jj) {
  o = jj = -1;
  if (col < sh.hsp()) { if (col < hs) o = col; }
  else if (col < sh.c0()) { if (col - sh.hsp() < hv) o = hs + col - sh.hsp(); }
  else if (col < sh.n()) { if (col - sh.c0() < hv) jj = col - sh.c0(); }
}

// ---------------------------------------------------------------------------
// The weights: the six folded blocks (the TPU kernel's, reference row layout
// split) as W [wrows][n] bf16 (padded row r, layer column col) and the d2 rows
// of W0a and W1Sa as d2w [n] fp32.  KM: the W0 vector rows are CG110 times
// the weight, rounded (the km2 form's w0v).
template <bool KM, class S>
__device__ __forceinline__ float weight_at(const S& sh, int r, int col, const bf16* w0a,
                                           const bf16* w1sa, const bf16* w1va, const bf16* w0b,
                                           const bf16* w1sb, const bf16* w1vb, int hs, int hv) {
  const int s1 = 2 * hs + 1, c0 = hs + hv;
  const int hsp = sh.hsp(), hvp = sh.hvp();
  int o, jj;
  out_col(sh, col, hs, hv, o, jj);
  const bf16 *src0 = nullptr, *src1 = nullptr;
  int i0 = 0, i1 = 0, w1 = hv;
  bool vec = false;
  if (r < sh.w1v()) {
    const int p = r % hsp;
    if (p < hs) { i0 = i1 = r < hsp ? p : hs + p; src0 = w0a; src1 = w1sa; }
  } else if (r < sh.w2s()) {
    const int p = (r - sh.w1v()) % hvp;
    if (p < hv) {
      const int l = r - sh.w1v() < hvp ? p : hv + p;
      i0 = s1 + l; i1 = l; src0 = w0a; src1 = w1va; vec = true;
    }
  } else if (r < sh.w2v()) {
    const int p = r - sh.w2s();
    if (p < hs) { i0 = i1 = p; src0 = w0b; src1 = w1sb; }
  } else {
    const int p = r - sh.w2v();
    if (p < hv) { i0 = hs + p; i1 = p; src0 = w0b; src1 = w1vb; vec = true; }
  }
  float v = 0.f;
  if (src0 != nullptr) {
    if (o >= 0) {
      v = bf(src0[i0 * c0 + o]);
      if (KM && vec) v = rnd(rnd(kCG) * v);
    } else if (jj >= 0) {
      v = bf(src1[i1 * w1 + jj]);
    }
  }
  return v;
}
template <class S>
__device__ __forceinline__ float d2_at(const S& sh, int col, const bf16* w0a, const bf16* w1sa,
                                       int hs, int hv) {
  const int c0 = hs + hv;
  int o, jj;
  out_col(sh, col, hs, hv, o, jj);
  return o >= 0 ? bf(w0a[2 * hs * c0 + o]) : jj >= 0 ? bf(w1sa[2 * hs * hv + jj]) : 0.f;
}
// ... once per block into shared memory (the Bench kernels: W [wrows][ldw])
template <bool KM, class S>
__device__ void stage_weights(const S& sh, bf16* W, float* d2w, const bf16* w0a,
                              const bf16* w1sa, const bf16* w1va, const bf16* w0b,
                              const bf16* w1sb, const bf16* w1vb, int hs, int hv) {
  const int ldw = sh.ldw();
  for (int x = threadIdx.x; x < sh.wrows() * ldw; x += blockDim.x)
    W[x] = __float2bfloat16(
        weight_at<KM>(sh, x / ldw, x % ldw, w0a, w1sa, w1va, w0b, w1sb, w1vb, hs, hv));
  for (int col = threadIdx.x; col < sh.n(); col += blockDim.x)
    d2w[col] = d2_at(sh, col, w0a, w1sa, hs, hv);
}

// ---------------------------------------------------------------------------
// The gather.  A tile: unit rows q0 .. q0+15 of the unit of receivers
// [node0, node0 + nrecv) (nrecv 0: an empty tile); unit row q is slot q % K
// of receiver node0 + q / K, live when q < nrecv K.
struct TileRef {
  int node0, nrecv, q0;
  int slot0;  // the backward's TAB scratch: the unit's first slot in its gather tile
};

// one warp's buffer in shared memory
struct Buf {
  bf16* s;     // [16][ldf] sender rows (zeros: no sender)
  bf16* r;     // [tile_recv][ldf] receiver rows
  bf16* d;     // [tile_recv][ldf] d_agg rows (backward)
  float* geo;  // [16][8]: s, vx, vy, vz, mask, d2
  int* ri;     // [16] each row's receiver row in r
  int* snd;    // [16] each row's sender row (-1: none)
};

template <class S>
__device__ inline Buf carve_buf(const S& sh, unsigned char* p, int k, bool dagg) {
  Buf b;
  const int rw = tile_recv(k);
  b.s = reinterpret_cast<bf16*>(p);
  p += align16(2L * 16 * sh.ldf());
  b.r = reinterpret_cast<bf16*>(p);
  p += align16(2L * rw * sh.ldf());
  b.d = reinterpret_cast<bf16*>(p);
  if (dagg) p += align16(2L * rw * sh.ldf());
  b.geo = reinterpret_cast<float*>(p);
  p += align16(4L * 16 * 8);
  b.ri = reinterpret_cast<int*>(p);
  p += align16(4L * 16);
  b.snd = reinterpret_cast<int*>(p);
  return b;
}
__device__ inline Buf carve_buf(unsigned char* p, int k, bool dagg) {
  return carve_buf(Bench(), p, k, dagg);
}

// How a feature row is copied: 16-byte chunks (widths multiples of 8, rows
// 16-byte aligned), 4-byte words (even widths, 4-byte aligned) or elements.
enum CopyMode { kCopy16 = 0, kCopy4 = 1, kCopy2 = 2 };

// chunk ch (8 padded columns) of a feature row: src row of F features
// (null: zeros) into the padded dst row; padded lanes stay as they are (zero)
template <class S>
__device__ __forceinline__ void copy_chunk(const S& sh, bf16* dst, const bf16* src, int ch,
                                           int hs, int hv, int mode) {
  const int pc = ch * 8;
  int fc, n;
  if (pc < sh.hsp()) {
    fc = pc;
    n = hs - pc;
  } else {
    const int c = (pc - sh.hsp()) / sh.hvp(), j = (pc - sh.hsp()) % sh.hvp();
    fc = hs + c * hv + j;
    n = hv - j;
  }
  if (n <= 0) return;
  if (n > 8) n = 8;
  bf16* d = dst + pc;
  if (src == nullptr) {
    *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  } else if (mode == kCopy16) {
    cp_async16(d, src + fc);
  } else if (mode == kCopy4) {
    for (int w = 0; w < n; w += 2) cp_async4(d + w, src + fc + w);
  } else {
    for (int w = 0; w < n; ++w) d[w] = src[fc + w];
  }
}

// the copy mode of rows at these bases: 16-byte chunks where every base is
// 16-byte aligned and the widths are multiples of 8, words where they are
// even, else elements
__host__ inline int copy_mode(int hs, int hv, std::initializer_list<const void*> rows) {
  uintptr_t any = 0;
  for (const void* p : rows) any |= reinterpret_cast<uintptr_t>(p);
  if (hs % 8 == 0 && hv % 8 == 0 && any % 16 == 0) return kCopy16;
  if (hs % 2 == 0 && hv % 2 == 0 && any % 4 == 0) return kCopy4;
  return kCopy2;
}

struct GatherArgs {
  const bf16* h;      // TAB: the features (senders by the table, receivers); else receivers
  const bf16* hsp;    // KM: hs3 [K, N, F]; FLAT: hs [N*K, F]
  const bf16* d2;
  const bf16* attr;
  const bf16* maskf;
  const int* loc;
  const int* gtab;
  const bf16* geo2;   // KM
  const bf16* dagg;   // backward: d_agg [N, F]
  int npad, hs, hv, k, tile, u, mode;
};

// the warp gathers tile tr into b (asynchronously: the caller commits and
// waits); lanes 0-15 own a row's ids and geometry
template <Addr A, class S = Bench>
__device__ void gather_tile(const Buf& b, const TileRef& tr, const GatherArgs& ga, int lane,
                            const S& sh = S()) {
  const int k = ga.k, f = ga.hs + 3 * ga.hv;
  const int rel0 = tr.q0 / k;
  if (lane < 16) {
    const int q = tr.q0 + lane;
    const bool live = q < tr.nrecv * k;
    const int rel = q / k, kk = q % k;
    const int node = tr.node0 + rel;
    int snd = -1;
    float g[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (live) {
      const long e = (long)node * k + kk;
      if (A == Addr::kKm) {
        snd = kk * ga.npad + node;  // K*N < 2^31, checked by the wrapper
        const bf16* gg = ga.geo2 + e * 6;  // sh 4, d2, mask
#pragma unroll
        for (int c = 0; c < 4; ++c) g[c] = bf(gg[c]);
        g[4] = bf(gg[5]);
        g[5] = bf(gg[4]);
      } else {
        if (A == Addr::kFlat) {
          snd = (int)e;  // N*K < 2^31, checked by the wrapper
        } else {
          const int l = ga.loc[e];
          if (l < ga.u) {
            const int t = ga.gtab[(long)(node / ga.tile) * ga.u + l];
            snd = (t >= 0 && t < ga.npad) ? t : -1;
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) g[c] = bf(ga.attr[e * 4 + c]);
        g[4] = bf(ga.maskf[e]);
        g[5] = bf(ga.d2[e]);
      }
    }
    b.snd[lane] = snd;
    b.ri[lane] = live ? rel - rel0 : 0;
    float4* gp = reinterpret_cast<float4*>(b.geo + lane * 8);
    gp[0] = make_float4(g[0], g[1], g[2], g[3]);
    gp[1] = make_float4(g[4], g[5], 0.f, 0.f);
  }
  __syncwarp();
  const bf16* hsrc = A == Addr::kTab ? ga.h : ga.hsp;
  const int chunks = sh.chunks(), ldf = sh.ldf();
  for (int x = lane; x < 16 * chunks; x += 32) {
    const int row = x / chunks, ch = x % chunks;
    const int snd = b.snd[row];
    copy_chunk(sh, b.s + row * ldf, snd >= 0 ? hsrc + (long)snd * f : nullptr, ch, ga.hs,
               ga.hv, ga.mode);
  }
  const int rw = tile_recv(k);
  const int nrow = ga.dagg != nullptr ? 2 * rw : rw;
  for (int x = lane; x < nrow * chunks; x += 32) {
    const int j = x / chunks, ch = x % chunks;
    const bool dg = j >= rw;
    const int jr = dg ? j - rw : j;
    const bool live = rel0 + jr < tr.nrecv;
    const long node = tr.node0 + rel0 + jr;
    const bf16* src = live ? (dg ? ga.dagg : ga.h) + node * f : nullptr;
    copy_chunk(sh, (dg ? b.d : b.r) + jr * ldf, src, ch, ga.hs, ga.hv, ga.mode);
  }
}

// ---------------------------------------------------------------------------
// The products, an n-tile pair at a time (so that few accumulators are
// live): acc[2][4] += A @ W[wrow .. wrow+16][col0 .. col0+16), the weights
// by ldmatrix.trans
__device__ __forceinline__ void mma_pair(float (&acc)[2][4], const uint32_t (&a)[4],
                                         const bf16* W, int wrow, int col0, int lane) {
  uint32_t b[4];
  ldsm_x4_t(b, W + (wrow + (lane & 15)) * kLdW + col0 + (lane >> 4) * 8);
  mma_bf16_16816(acc[0], a, b[0], b[1]);
  mma_bf16_16816(acc[1], a, b[2], b[3]);
}

// The VJP's products: acc[2][4] += A @ W[nrow .. nrow+16][kcol .. kcol+16)^T
// (n-tiles of input rows), the weights by plain ldmatrix
__device__ __forceinline__ void mma_pairT(float (&acc)[2][4], const uint32_t (&a)[4],
                                          const bf16* W, int nrow, int kcol, int lane) {
  uint32_t b[4];
  ldsm_x4(b, W + (nrow + (lane & 7) + (lane >> 4) * 8) * kLdW + kcol + ((lane >> 3) & 1) * 8);
  mma_bf16_16816(acc[0], a, b[0], b[1]);
  mma_bf16_16816(acc[1], a, b[2], b[3]);
}

template <int N> __device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
}

// A tile's geometry for this lane's rows g and g + 8, read from the
// buffer where it is used (held in registers for the whole tile, its twelve
// values would crowd the backward's accumulators)
struct RowGeo {
  const float* p;  // row g's [s, vx, vy, vz, mask, d2]; row g + 8 at p + 64
  __device__ __forceinline__ float s(int h) const { return p[h * 64]; }
  __device__ __forceinline__ float v(int h, int c) const { return p[h * 64 + 1 + c]; }
  __device__ __forceinline__ float mk(int h) const { return p[h * 64 + 4]; }
  __device__ __forceinline__ float d2(int h) const { return p[h * 64 + 5]; }
};
__device__ __forceinline__ RowGeo row_geo(const float* geo, int g) { return RowGeo{geo + g * 8}; }

// Layer 1 of a tile: o0 [6 n-tiles], oa [2], ob [3 components][2] (C
// fragments), from the gathered rows: o0 = s (xs W0s + d2 w0_d2) + cgd sum_c
// v_c (xv_c W0v), A = xs W1S + d2 w1_d2, B_c = s (xv_c W1V).  cgd: CG110
// (tabled rounding) or 1 (KM: folded into the staged rows).
__device__ __forceinline__ void layer1(const bf16* W, const float* d2w, const Buf& b,
                                       const RowGeo& rg, float cgd, int lane,
                                       float (&o0)[6][4], float (&oa)[2][4],
                                       float (&ob)[3][2][4]) {
  const int t4 = lane & 3;
  const int ar = lane & 15, ac = (lane >> 4) * 8;
  const bf16* as = b.s + ar * kLdF + ac;
  const bf16* arr = b.r + b.ri[ar] * kLdF + ac;
  {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      float t[2][4];
      zero(t);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // (the A fragments reloaded per pair: fewer live)
        uint32_t a[4];
        ldsm_x4(a, (ks < 2 ? as : arr) + (ks & 1) * 16);
        mma_pair(t, a, W, kW1s + ks * 16, np * 16, lane);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = q >> 1, nt = 2 * np + j, col = nt * 8 + 2 * t4 + (q & 1);
          const float x = fmaf(rg.d2(h), d2w[col], t[j][q]);
          if (nt < 6) o0[nt][q] = rg.s(h) * x;
          else oa[nt - 6][q] = x;
        }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    uint32_t a[2][4];
    ldsm_x4(a[0], as + kHS + kHV * c);
    ldsm_x4(a[1], arr + kHS + kHV * c);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      float t[2][4];
      zero(t);
      mma_pair(t, a[0], W, kW1v, np * 16, lane);
      mma_pair(t, a[1], W, kW1v + 16, np * 16, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = q >> 1, nt = 2 * np + j;
          if (nt < 6) o0[nt][q] = fmaf(cgd * rg.v(h, c), t[j][q], o0[nt][q]);
          else ob[c][nt - 6][q] = rg.s(h) * t[j][q];
        }
    }
  }
}

// Layer 2 of a tile on the rounded layer-1 outputs m0 (2 k-steps) and m1_c
// (1 k-step each), in A fragments.
__device__ __forceinline__ void layer2(const bf16* W, const RowGeo& rg, float cgd, int lane,
                                       const uint32_t (&am0)[2][4],
                                       const uint32_t (&am1)[3][4], float (&o0)[6][4],
                                       float (&oa)[2][4], float (&ob)[3][2][4]) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    float t[2][4];
    zero(t);
    mma_pair(t, am0[0], W, kW2s, np * 16, lane);
    mma_pair(t, am0[1], W, kW2s + 16, np * 16, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int nt = 2 * np + j;
        if (nt < 6) o0[nt][q] = rg.s(q >> 1) * t[j][q];
        else oa[nt - 6][q] = t[j][q];
      }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      float t[2][4];
      zero(t);
      mma_pair(t, am1[c], W, kW2v, np * 16, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = q >> 1, nt = 2 * np + j;
          if (nt < 6) o0[nt][q] = fmaf(cgd * rg.v(h, c), t[j][q], o0[nt][q]);
          else ob[c][nt - 6][q] = rg.s(h) * t[j][q];
        }
    }
}

// The layer-1 gate: m0 = silu(o0) and m1_c = CG011 (v_c A + B_c) sigmoid(o0v),
// rounded to bf16, as the layer-2 A fragments.  KM rounds A and the sigmoid
// first (the km2 form).
template <bool KM>
__device__ __forceinline__ void gate1(const float (&o0)[6][4], const float (&oa)[2][4],
                                      const float (&ob)[3][2][4], const RowGeo& rg,
                                      uint32_t (&am0)[2][4], uint32_t (&am1)[3][4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    float m[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) m[q] = o0[nt][q] * sigm(o0[nt][q]);
    am0[nt >> 1][(nt & 1) * 2 + 0] = pack(m[0], m[1]);
    am0[nt >> 1][(nt & 1) * 2 + 1] = pack(m[2], m[3]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float m[3][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int h = q >> 1;
      const float g = KM ? rnd(sigm(o0[4 + i][q])) : sigm(o0[4 + i][q]);
      const float a = KM ? rnd(oa[i][q]) : oa[i][q];
#pragma unroll
      for (int c = 0; c < 3; ++c) m[c][q] = kCG * fmaf(rg.v(h, c), a, ob[c][i][q]) * g;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      am1[c][i * 2 + 0] = pack(m[c][0], m[c][1]);
      am1[c][i * 2 + 1] = pack(m[c][2], m[c][3]);
    }
  }
}

// an A fragment (k-step of 16 columns from col0) back to row-major rows
// r0 + g, r0 + g + 8 of a staging array
__device__ __forceinline__ void store_a(bf16* Y, int ld, int r0, int col0, const uint32_t (&a)[4],
                                        int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  uint32_t* p0 = reinterpret_cast<uint32_t*>(Y + (r0 + g) * ld + col0 + 2 * t4);
  uint32_t* p1 = reinterpret_cast<uint32_t*>(Y + (r0 + g + 8) * ld + col0 + 2 * t4);
  p0[0] = a[0];
  p1[0] = a[1];
  p0[4] = a[2];
  p1[4] = a[3];
}

// ---------------------------------------------------------------------------
// The Wide kernels (bf16 past 32x0e+16x1o).
//
// Instances.  The kernels are templates on m, the count of scalar blocks (32
// lanes) and of vector blocks (16 channels) alike (WideS<m>), built for m = 1
// .. LMAX1_WIDE_MAX_M.  A width of ns scalar and nv vector blocks (wide_shape) runs
// the instance m = max(ns, nv); its missing blocks are zero-padded as the
// lanes within a block are (zero inputs, zero weights), and a zero k-step
// adds an exact 0 to every fp32 sum.  Every loop over blocks and k-steps
// unrolls.  Each output column is summed over the k-steps of the Bench
// layers' order (scalars: sender, then receiver; each component's vector
// lanes: sender, then receiver), so at m = 1 every value is the Bench
// layers' bit for bit.
//
// Layer 1 to layer 2 in registers.  Layer 1's gated outputs m0 | m1_c go
// from C fragments into layer 2's A fragments (as the Bench kernels' gate1):
// 2m k-steps of m0 and m of each m1_c, 20 m registers a lane.
//
// The weights, streamed by column block.  The launch's first kernel
// (wide_pack) lays the weights out in device memory as chunks.  Column block
// cb (32 columns: scalar block cb < m, else vector block cb - m, its 16 gate
// and 16 OA columns) has three: layer 1's scalar-input rows, its vector-input
// rows, and layer 2's rows.  The backward's transposed products read row
// chunks (16 input rows x every column).  A chunk's rows are 64 bytes (a row
// chunk: panels of 32 columns), the 16-byte units of row r swizzled by (r >>
// 1) & 3, so that ldmatrix and ldmatrix.trans read them without bank
// conflicts.  A block's warps walk one sequence of chunks, tile by tile, and
// share a ring of stages of 4096 m bytes in shared memory: a chunk is copied
// by cp.async.bulk against its stage's full mbarrier (generic_mma.cuh's ring
// pattern), and the last warp to release a stage copies the next chunk into
// it.  No block holds a whole width's weights.  (A profiling build of the
// backward, LMAX1_BWD_CLOCKS, adds thread 0's waits on the mbarriers to
// bwd_phase_cycles[15].)
template <int M> struct WideM {
  static constexpr int ns = M, nv = M;
};
template <int M> using WideS = Shape<WideM<M>>;
// the instances built: m = 1 .. LMAX1_WIDE_MAX_M (kernels/fused_message.py:
// WIDE_MAX_M), each in a library of its own (LMAX1_WIDE_M=m), so that the
// instances compile side by side; LMAX1_WIDE_CASES(CALL) is a switch's case
// of the library's instance (another width's falls through to the default)
#define LMAX1_WIDE_MAX_M 4
#ifndef LMAX1_WIDE_M
#define LMAX1_WIDE_M 1
#endif
#if LMAX1_WIDE_M < 1 || LMAX1_WIDE_M > LMAX1_WIDE_MAX_M
#error "LMAX1_WIDE_M: one of the instances 1 .. LMAX1_WIDE_MAX_M"
#endif
#define LMAX1_WIDE_CASES(CALL) \
  case LMAX1_WIDE_M: CALL(LMAX1_WIDE_M);
// the instance a width runs
__host__ __device__ inline int wide_m(int hs, int hv) {
  const Wide s = wide_shape(hs, hv);
  return s.ns > s.nv ? s.ns : s.nv;
}
// ring stages: four up to m = 2, two past it (shared memory for warps)
template <int M> __host__ __device__ constexpr int wide_stages() { return M <= 2 ? 4 : 2; }

// The packed weights of instance M (bytes): per column block the layer-1
// scalar and vector chunks, then per column block the layer-2 chunk, then the
// row chunks of layer 2 (3m: m0 rows, m1 rows) and of layer 1 (6m: sender,
// receiver scalars; sender, receiver vector lanes), then d2w [n] fp32.
template <int M> struct WidePack {
  static constexpr int HSP = 32 * M, HVP = 16 * M, C0 = 48 * M, NC = 64 * M;
  static constexpr long L1S = 64L * 2 * HSP, L1V = 64L * 2 * HVP, L2 = 64L * (HSP + HVP);
  static constexpr long ROW = 2L * 16 * NC;
  static constexpr long STAGE = L1S;  // the largest chunk
  static constexpr long L2_OFF = 2L * M * (L1S + L1V);
  static constexpr long L2T_OFF = L2_OFF + 2L * M * L2;
  static constexpr long L1T_OFF = L2T_OFF + 3L * M * ROW;
  static constexpr long D2W_OFF = L1T_OFF + 6L * M * ROW;
  static constexpr long BYTES = D2W_OFF + 4L * NC;
  // a tile's chunks: forward layer 1 (4m), layer 2 (2m); backward also layer
  // 2's row chunks (3m), layer 1 again (4m), layer 1's row chunks (6m)
  static constexpr int FWD_CHUNKS = 6 * M, BWD_CHUNKS = 19 * M;
  __host__ __device__ static void chunk(bool bwd, int j, long& off, int& bytes) {
    if (bwd && j >= 6 * M) {
      if (j < 9 * M) {
        off = L2T_OFF + (j - 6 * M) * ROW;
        bytes = (int)ROW;
        return;
      }
      if (j >= 13 * M) {
        off = L1T_OFF + (j - 13 * M) * ROW;
        bytes = (int)ROW;
        return;
      }
      j -= 9 * M;
    }
    if (j < 4 * M) {
      off = (j >> 1) * (L1S + L1V) + (j & 1) * L1S;
      bytes = (int)((j & 1) ? L1V : L1S);
    } else {
      off = L2_OFF + (j - 4 * M) * L2;
      bytes = (int)L2;
    }
  }
  // column c of column block cb -> the layer's column
  __host__ __device__ static int col_of(int cb, int c) {
    if (cb < M) return 32 * cb + c;
    return c < 16 ? HSP + 16 * (cb - M) + c : C0 + 16 * (cb - M) + c - 16;
  }
};

// A chunk's element p (panels of `rows` rows x 32 columns, 64-byte rows,
// 16-byte units swizzled by (row >> 1) & 3) -> (row, col)
__host__ __device__ inline void unswz(int p, int rows, int& row, int& col) {
  const int panel = p / (rows * 32), rem = p % (rows * 32);
  row = rem / 32;
  col = panel * 32 + ((((rem >> 3) & 3) ^ ((row >> 1) & 3)) << 3) + (rem & 7);
}

// The packed weights of instance M into dst (WidePack<M>::BYTES), from the
// six blocks (stage_weights' values; KM: the W0 vector rows CG110-scaled).
template <bool KM, int M>
__global__ void __launch_bounds__(256)
lmax1_wide_pack(unsigned char* __restrict__ dst, const bf16* __restrict__ w0a,
                const bf16* __restrict__ w1sa, const bf16* __restrict__ w1va,
                const bf16* __restrict__ w0b, const bf16* __restrict__ w1sb,
                const bf16* __restrict__ w1vb, int hs, int hv) {
  typedef WidePack<M> P;
  const WideS<M> sh{};
  bf16* out = reinterpret_cast<bf16*>(dst);
  const int n = (int)(P::D2W_OFF / 2), step = gridDim.x * blockDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += step) {
    long o = 2L * e;
    int r, col, lr, lc;
    if (o < P::L2_OFF) {
      const int cb = (int)(o / (P::L1S + P::L1V));
      o -= cb * (P::L1S + P::L1V);
      const bool vec = o >= P::L1S;
      if (vec) o -= P::L1S;
      unswz((int)(o / 2), vec ? 2 * P::HVP : 2 * P::HSP, lr, lc);
      r = (vec ? sh.w1v() : sh.w1s()) + lr;
      col = P::col_of(cb, lc);
    } else if (o < P::L2T_OFF) {
      o -= P::L2_OFF;
      const int cb = (int)(o / P::L2);
      unswz((int)((o - cb * P::L2) / 2), P::HSP + P::HVP, lr, lc);
      r = sh.w2s() + lr;
      col = P::col_of(cb, lc);
    } else {
      const bool l1 = o >= P::L1T_OFF;
      o -= l1 ? P::L1T_OFF : P::L2T_OFF;
      const int p = (int)(o / P::ROW);
      unswz((int)((o - p * P::ROW) / 2), 16, lr, lc);
      r = (l1 ? sh.w1s() : sh.w2s()) + 16 * p + lr;
      col = lc;
    }
    out[e] = __float2bfloat16(weight_at<KM>(sh, r, col, w0a, w1sa, w1va, w0b, w1sb, w1vb, hs, hv));
  }
  float* d2w = reinterpret_cast<float*>(dst + P::D2W_OFF);
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < P::NC; c += step)
    d2w[c] = d2_at(sh, c, w0a, w1sa, hs, hv);
}

// The ring of weight chunks (see above): stage i at stage + i STAGE, its full
// mbarrier (the copy's bytes) and its release count; chunk q of the block's
// sequence is chunk q % per-tile of a tile.  Every warp acquires and
// releases every chunk in order.  A chunk's warps release it by counting:
// the last of them (its count reaching a multiple of the warps) copies the
// chunk kS later into the stage, so no warp waits for another to refill.
template <int M, bool BWD> struct WRing {
  typedef WidePack<M> P;
  static constexpr int kS = wide_stages<M>();
  static constexpr int kPerTile = BWD ? P::BWD_CHUNKS : P::FWD_CHUNKS;
  static constexpr long kBytes = kS * (P::STAGE + 16);  // shared memory: stages, barriers
  const unsigned char* src;
  unsigned char* stage;
  uint64_t* full;
  unsigned* count;
  int total, nwarps;

  __device__ void setup(unsigned char* p, const unsigned char* w, int n, int warps) {
    src = w;
    stage = p;
    full = reinterpret_cast<uint64_t*>(p + kS * P::STAGE);
    count = reinterpret_cast<unsigned*>(full + kS);
    total = n;
    nwarps = warps;
  }
  // one thread copies chunk q into its stage (every warp has released the
  // chunk that stage held, q - kS)
  __device__ void issue(int q) {
    if (q >= total) return;
    const int st = q % kS;
    long off;
    int bytes;
    P::chunk(BWD, q % kPerTile, off, bytes);
    gmma::mbar_expect_tx(full + st, (uint32_t)bytes);
    gmma::bulk_copy(stage + st * P::STAGE, src + off, (uint32_t)bytes, full + st);
  }
  // barriers initialised, the first chunks on their way; ends with a block
  // barrier
  __device__ void start() {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kS; ++i) {
        gmma::mbar_init(full + i, 1);
        count[i] = 0;
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int q = 0; q < kS; ++q) issue(q);
    }
    __syncthreads();
  }
  // chunk q, once it has landed
  __device__ const bf16* acquire(int q) const {
    const int st = q % kS;
#ifdef LMAX1_BWD_CLOCKS
    const long long t0 = clock64();
#endif
    gmma::mbar_wait(full + st, (uint32_t)((q / kS) & 1));
#ifdef LMAX1_BWD_CLOCKS
    if (threadIdx.x == 0) atomicAdd(&bwd_phase_cycles[15], (unsigned long long)(clock64() - t0));
#endif
    return reinterpret_cast<const bf16*>(stage + st * P::STAGE);
  }
  // the warp is done with chunk q (its reads of the stage before the count;
  // the last warp's copy after it)
  __device__ void release(int q, int lane) {
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      const unsigned n = atomicAdd(count + q % kS, 1u);
      if (n % nwarps == nwarps - 1) {
        __threadfence_block();
        issue(q + kS);
      }
    }
    __syncwarp();
  }
};

// This lane's ldmatrix offsets into a column chunk (elements; row lane & 15,
// columns 16 hp + (lane >> 4) 8, for hp = 0, 1) and into a row chunk (row (lane
// & 7) + (lane >> 4) 8, columns ((lane >> 3) & 1) 8 of a 32-column panel's
// first or second half)
struct ChunkLane {
  int c[2], r[2];
};
__device__ __forceinline__ ChunkLane chunk_lane(int lane) {
  ChunkLane cl;
  const int rc = lane & 15, rr = (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
  for (int hp = 0; hp < 2; ++hp) {
    cl.c[hp] = rc * 32 + (((2 * hp + (lane >> 4)) ^ ((rc >> 1) & 3)) << 3);
    cl.r[hp] = rr * 32 + (((2 * hp + ((lane >> 3) & 1)) ^ ((rr >> 1) & 3)) << 3);
  }
  return cl;
}
// acc[hp] += a @ chunk[kr .. kr+16)[16 hp .. 16 hp + 16), hp = 0, 1 (the
// column chunk's 32 columns as two n-tile pairs)
__device__ __forceinline__ void mma_cc(float (&acc)[2][2][4], const uint32_t (&a)[4],
                                       const bf16* ch, int kr, const ChunkLane& cl) {
#pragma unroll
  for (int hp = 0; hp < 2; ++hp) {
    uint32_t b[4];
    ldsm_x4_t(b, ch + kr * 32 + cl.c[hp]);
    mma_bf16_16816(acc[hp][0], a, b[0], b[1]);
    mma_bf16_16816(acc[hp][1], a, b[2], b[3]);
  }
}
// acc += a @ chunk[0 .. 16)[kc .. kc+16)^T: the row chunk's 16 input rows as
// an n-tile pair, k-step kc (a multiple of 16) of its columns
__device__ __forceinline__ void mma_rc(float (&acc)[2][4], const uint32_t (&a)[4],
                                       const bf16* ch, int kc, const ChunkLane& cl) {
  uint32_t b[4];
  ldsm_x4(b, ch + (kc >> 5) * 512 + cl.r[(kc >> 4) & 1]);
  mma_bf16_16816(acc[0], a, b[0], b[1]);
  mma_bf16_16816(acc[1], a, b[2], b[3]);
}

template <int N> __device__ __forceinline__ void zero2(float (&x)[2][N][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) zero(x[i]);
}

// A column block's scalar-input part on its chunk: t[hp] = sum over the
// sources (layer 1: sender, receiver; layer 2: m0) and their 2m k-steps of
// A(src, ks) times the chunk's rows (src 2m + ks) 16 .., columns 16 hp ..
template <int M, int NSRC, class FA>
__device__ __forceinline__ void part_s(const bf16* ch, const ChunkLane& cl, FA fa,
                                       float (&t)[2][2][4]) {
  zero2(t);
#pragma unroll
  for (int src = 0; src < NSRC; ++src)
#pragma unroll
    for (int ks = 0; ks < 2 * M; ++ks) {
      uint32_t a[4];
      fa(src, ks, a);
      mma_cc(t, a, ch, (src * 2 * M + ks) * 16, cl);
    }
}
// its vector-input part of component c: the sources' m k-steps from chunk
// row row0 (layer 1: sender, receiver lanes; layer 2: m1_c)
template <int M, int NSRC, class FA>
__device__ __forceinline__ void part_v(const bf16* ch, int row0, const ChunkLane& cl, FA fa,
                                       float (&t)[2][2][4]) {
  zero2(t);
#pragma unroll
  for (int src = 0; src < NSRC; ++src)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      uint32_t a[4];
      fa(src, j, a);
      mma_cc(t, a, ch, row0 + (src * M + j) * 16, cl);
    }
}

// Scalar block cb's O0 columns from the scalar part: o[n-tile] = s (t + d2
// d2w) (layer 2: s t); then each component's vector part: o += cgd v_c t
template <bool L1>
__device__ __forceinline__ void sblk_s(const float (&t)[2][2][4], const float* d2w, int col0,
                                       const RowGeo& rg, int t4, float (&o)[4][4]) {
#pragma unroll
  for (int hp = 0; hp < 2; ++hp)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = q >> 1, col = col0 + 16 * hp + 8 * j + 2 * t4 + (q & 1);
        const float x = L1 ? fmaf(rg.d2(h), d2w[col], t[hp][j][q]) : t[hp][j][q];
        o[2 * hp + j][q] = rg.s(h) * x;
      }
}
__device__ __forceinline__ void sblk_v(const float (&t)[2][2][4], float cgd, int c,
                                       const RowGeo& rg, float (&o)[4][4]) {
#pragma unroll
  for (int hp = 0; hp < 2; ++hp)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        o[2 * hp + j][q] = fmaf(cgd * rg.v(q >> 1, c), t[hp][j][q], o[2 * hp + j][q]);
}
// Vector block v's gate columns og and OA columns oa from the scalar part (t[0]
// the gate columns, t[1] OA); then each component's vector part: og += cgd
// v_c t[0], ob[c] = s t[1]
template <int M, bool L1>
__device__ __forceinline__ void vblk_s(const float (&t)[2][2][4], const float* d2w, int v,
                                       const RowGeo& rg, int t4, float (&og)[2][4],
                                       float (&oa)[2][4]) {
  constexpr int HSP = 32 * M, C0 = 48 * M;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int h = q >> 1, col = 16 * v + 8 * j + 2 * t4 + (q & 1);
      og[j][q] = rg.s(h) * (L1 ? fmaf(rg.d2(h), d2w[HSP + col], t[0][j][q]) : t[0][j][q]);
      oa[j][q] = L1 ? fmaf(rg.d2(h), d2w[C0 + col], t[1][j][q]) : t[1][j][q];
    }
}
__device__ __forceinline__ void vblk_v(const float (&t)[2][2][4], float cgd, int c,
                                       const RowGeo& rg, float (&og)[2][4],
                                       float (&ob)[3][2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      og[j][q] = fmaf(cgd * rg.v(q >> 1, c), t[0][j][q], og[j][q]);
      ob[c][j][q] = rg.s(q >> 1) * t[1][j][q];
    }
}

// Layer 1 on the gather buffer (xs, xr: this lane's ldmatrix rows of the
// sender and receiver features): a scalar block's o (cb < M) or a vector
// block's og, oa, ob (cb >= M), on the block's two chunks from the ring
// (chunks q, q + 1)
template <int M, class R>
__device__ __forceinline__ void l1_sblk(R& ring, int q, int lane, const ChunkLane& cl,
                                        const bf16* xs, const bf16* xr, const float* d2w,
                                        const RowGeo& rg, float cgd, int cb, float (&o)[4][4]) {
  constexpr int HSP = 32 * M, HVP = 16 * M;
  float t[2][2][4];
  const bf16* ch = ring.acquire(q);
  part_s<M, 2>(ch, cl, [&](int src, int ks, uint32_t (&a)[4]) {
    ldsm_x4(a, (src ? xr : xs) + 16 * ks);
  }, t);
  ring.release(q, lane);
  sblk_s<true>(t, d2w, 32 * cb, rg, lane & 3, o);
  ch = ring.acquire(q + 1);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    part_v<M, 2>(ch, 0, cl, [&](int src, int j, uint32_t (&a)[4]) {
      ldsm_x4(a, (src ? xr : xs) + HSP + HVP * c + 16 * j);
    }, t);
    sblk_v(t, cgd, c, rg, o);
  }
  ring.release(q + 1, lane);
}
template <int M, class R>
__device__ __forceinline__ void l1_vblk(R& ring, int q, int lane, const ChunkLane& cl,
                                        const bf16* xs, const bf16* xr, const float* d2w,
                                        const RowGeo& rg, float cgd, int v, float (&og)[2][4],
                                        float (&oa)[2][4], float (&ob)[3][2][4]) {
  constexpr int HSP = 32 * M, HVP = 16 * M;
  float t[2][2][4];
  const bf16* ch = ring.acquire(q);
  part_s<M, 2>(ch, cl, [&](int src, int ks, uint32_t (&a)[4]) {
    ldsm_x4(a, (src ? xr : xs) + 16 * ks);
  }, t);
  ring.release(q, lane);
  vblk_s<M, true>(t, d2w, v, rg, lane & 3, og, oa);
  ch = ring.acquire(q + 1);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    part_v<M, 2>(ch, 0, cl, [&](int src, int j, uint32_t (&a)[4]) {
      ldsm_x4(a, (src ? xr : xs) + HSP + HVP * c + 16 * j);
    }, t);
    vblk_v(t, cgd, c, rg, og, ob);
  }
  ring.release(q + 1, lane);
}
// Layer 2 on the A fragments am0 [2m] (m0) and am1 [m][3] (m1_c), one chunk
// (q) a column block
template <int M, class R>
__device__ __forceinline__ void l2_sblk(R& ring, int q, int lane, const ChunkLane& cl,
                                        const uint32_t (&am0)[2 * M][4],
                                        const uint32_t (&am1)[M][3][4], const RowGeo& rg,
                                        float cgd, float (&o)[4][4]) {
  float t[2][2][4];
  const bf16* ch = ring.acquire(q);
  part_s<M, 1>(ch, cl, [&](int, int ks, uint32_t (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = am0[ks][i];
  }, t);
  sblk_s<false>(t, nullptr, 0, rg, lane & 3, o);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    part_v<M, 1>(ch, 32 * M, cl, [&](int, int j, uint32_t (&a)[4]) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = am1[j][c][i];
    }, t);
    sblk_v(t, cgd, c, rg, o);
  }
  ring.release(q, lane);
}
template <int M, class R>
__device__ __forceinline__ void l2_vblk(R& ring, int q, int lane, const ChunkLane& cl,
                                        const uint32_t (&am0)[2 * M][4],
                                        const uint32_t (&am1)[M][3][4], const RowGeo& rg,
                                        float cgd, int v, float (&og)[2][4], float (&oa)[2][4],
                                        float (&ob)[3][2][4]) {
  float t[2][2][4];
  const bf16* ch = ring.acquire(q);
  part_s<M, 1>(ch, cl, [&](int, int ks, uint32_t (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = am0[ks][i];
  }, t);
  vblk_s<M, false>(t, nullptr, v, rg, lane & 3, og, oa);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    part_v<M, 1>(ch, 32 * M, cl, [&](int, int j, uint32_t (&a)[4]) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = am1[j][c][i];
    }, t);
    vblk_v(t, cgd, c, rg, og, ob);
  }
  ring.release(q, lane);
}

// The layer-1 gates as layer 2's A fragments: a scalar block's m0 = silu(o)
// (k-steps 2 cb, 2 cb + 1 of m0), a vector block's m1_c = CG011 (v_c A + B_c)
// sigmoid(og) (k-step v of each m1_c; KM rounds A and the sigmoid first, the
// km2 form), each rounded to bf16
__device__ __forceinline__ void gate_s(const float (&o)[4][4], uint32_t (&a0)[4],
                                       uint32_t (&a1)[4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    float m[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) m[q] = o[nt][q] * sigm(o[nt][q]);
    if (nt < 2) {
      a0[(nt & 1) * 2 + 0] = pack(m[0], m[1]);
      a0[(nt & 1) * 2 + 1] = pack(m[2], m[3]);
    } else {
      a1[(nt & 1) * 2 + 0] = pack(m[0], m[1]);
      a1[(nt & 1) * 2 + 1] = pack(m[2], m[3]);
    }
  }
}
template <bool KM>
__device__ __forceinline__ void gate_v(const float (&og)[2][4], const float (&oa)[2][4],
                                       const float (&ob)[3][2][4], const RowGeo& rg,
                                       uint32_t (&am)[3][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float m[3][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int h = q >> 1;
      const float g = KM ? rnd(sigm(og[i][q])) : sigm(og[i][q]);
      const float a = KM ? rnd(oa[i][q]) : oa[i][q];
#pragma unroll
      for (int c = 0; c < 3; ++c) m[c][q] = kCG * fmaf(rg.v(h, c), a, ob[c][i][q]) * g;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      am[c][i * 2 + 0] = pack(m[c][0], m[c][1]);
      am[c][i * 2 + 1] = pack(m[c][2], m[c][3]);
    }
  }
}

// Layer 1 of a tile and its gates: the layer-2 A fragments
template <int M, bool KM, class R>
__device__ __forceinline__ void layer1_wide(R& ring, int q, int lane, const ChunkLane& cl,
                                            const bf16* xs, const bf16* xr, const float* d2w,
                                            const RowGeo& rg, float cgd,
                                            uint32_t (&am0)[2 * M][4],
                                            uint32_t (&am1)[M][3][4]) {
#pragma unroll
  for (int cb = 0; cb < M; ++cb) {
    float o[4][4];
    l1_sblk<M>(ring, q + 2 * cb, lane, cl, xs, xr, d2w, rg, cgd, cb, o);
    gate_s(o, am0[2 * cb], am0[2 * cb + 1]);
  }
#pragma unroll
  for (int v = 0; v < M; ++v) {
    float og[2][4], oa[2][4], ob[3][2][4];
    l1_vblk<M>(ring, q + 2 * (M + v), lane, cl, xs, xr, d2w, rg, cgd, v, og, oa, ob);
    gate_v<KM>(og, oa, ob, rg, am1[v]);
  }
}

// ---------------------------------------------------------------------------
// The K-sum of a tile's rows held in a per-warp buffer [16][ldk] (padded
// columns): the lanes walk the rows in slot order, lane l owns padded columns
// l, l + 32, l + 64, ... (at most C), and each receiver's sum (its K slots in
// fp32, FLAT in groups of pack rounded once) is written to out [N, F] when its
// last slot is added.  The running sums carry over the unit's tiles.
template <int C> struct KSumN {
  float acc[C], grp[C];
};
typedef KSumN<3> KSum;  // Bench: 80 padded columns

template <int C> __device__ __forceinline__ void ksum_init(KSumN<C>& ks) {
#pragma unroll
  for (int j = 0; j < C; ++j) ks.acc[j] = ks.grp[j] = 0.f;
}

template <bool FLAT, typename KT, int C, class S = Bench>
__device__ __forceinline__ void ksum_tile(KSumN<C>& ks, const KT* buf, const TileRef& tr, int k,
                                          int pack_, int hs, int hv, bf16* out, int lane,
                                          const S& sh = S()) {
  const int f = hs + 3 * hv, ldk = sh.ldk();
  int col[C];  // the feature column of each owned padded column, or -1
#pragma unroll
  for (int j = 0; j < C; ++j)
    col[j] = lane + 32 * j < sh.fp() ? feat_col(sh, lane + 32 * j, hs, hv) : -1;
  const int live = tr.nrecv * k - tr.q0;
  for (int i = 0; i < 16 && i < live; ++i) {
    const int q = tr.q0 + i;
    const int kk = q % k;
    if (kk == 0) {
#pragma unroll
      for (int j = 0; j < C; ++j) ks.acc[j] = ks.grp[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (col[j] < 0) continue;
      const float x = bf(buf[i * ldk + lane + 32 * j]);
      if (FLAT) {
        ks.grp[j] += x;
        if ((kk + 1) % pack_ == 0) {
          ks.acc[j] += rnd(ks.grp[j]);
          ks.grp[j] = 0.f;
        }
      } else {
        ks.acc[j] += x;
      }
    }
    if (kk == k - 1) {
      const long node = tr.node0 + q / k;
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (col[j] >= 0) out[node * f + col[j]] = __float2bfloat16(ks.acc[j]);
    }
  }
}

}  // namespace l1mma
