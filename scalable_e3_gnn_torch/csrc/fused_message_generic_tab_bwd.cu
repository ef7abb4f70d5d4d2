// Generic fused message + aggregation, backward, for Hopper (sm_90a): the
// tabled and the untabled sender addressing.
//
// Replaces the TPU kernels scalable_e3_gnn_tpu/kernels/fused_message_generic.py::
// FusedMessageGeneric._bwd_call_res_tab (#9, the residual backward: the forward
// saved each layer's pre-gate y) and _bwd_call_rep_tab (#10, the replay
// backward: y recomputed here, node-sized residuals only), their untabled
// counterparts _bwd_call_res (#12) and _bwd_call_rep (#13), all the z-free
// transpose chain _transpose_chain with the VJP of Gate.fast_apply, and the
// fallback _bwd_call (#14: an in-kernel jax.vjp of the tile forward, the same
// chain with the rounding of JAX's AD, see below).  Given the cotangent
// d_agg [N, dk_L] of
//
//   m0 = [x_s || h[i] || d2],  y_l = sum_c (m_l W_l[c]) attr_c,
//   m_l+1 = y_l[:, :dk_l] * sigmoid(y_l)[:, sel_l],   agg[i] = sum_k mask * m_L,
//
// for any number L >= 1 of message layers (the widths from the wrapper's
// layer table, generic_mma.cuh LayerField; L is a runtime value),
// (x_s = h[gtab[i / tile, loc[i,k]]] tabled, hs[k, i] untabled) per slot and
// layer, last to first: dy = VJP of the gate at y; dya_c = dy attr_c;
// dW_l[c] += m_l^T dya_c; dm_l-1 = sum_c dya_c W_l[c]^T.  Outputs: the sender
// cotangents (tabled: d_hu [ntiles*U, F], summed per table entry; untabled:
// d_hs [K, N, F], one row per slot, slot-major as the TPU kernel writes it),
// d_hr [N, F] (receiver cotangents summed over the K slots) and the fp32
// weight gradients.
//
// Rounding points (the TPU kernel's): dm_L = d_agg * mask rounded to the data
// type; the gate VJP as JAX's AD computes it (dout * multiplier and dout * y
// rounded; the selection transpose summed in fp32 and rounded; the sigmoid's
// VJP g * (s * (1 - s)) in fp32 and rounded; the two branches added and
// rounded; under another activation than silu, GENERIC_ACT of gate_act.cuh,
// the concat form's: see gate_vjp); dya_c = dy * attr_c rounded; the products in fp32; dm rounded; the
// d_hu and d_hr sums in fp32 of rounded terms, rounded once.  #14 rounds as
// JAX's AD of the layer: dya_c stays fp32; each component's dm_c is rounded
// and the components are added in the data type, the last first; dW_l[c] is
// summed in fp32 per backward tile (bwd_tile receivers, the TPU kernel's grid
// step), rounded, and the tiles are added in fp32 in tile order.
//
// Design: three kernels in this file, then the fixed-order reduction of
// csrc/fused_message_tab_bwd.cu.
// 1. chain (#9/#12, #10/#13 or #14 by a template mode; the sender addressing
//    by a flag).  One block owns whole receivers
//    (64 slot rows: 4 warps, two blocks an SM, in bf16; 8 warps in fp32), as
//    kernel #8 does, and runs the
//    chain for its rows: in replay mode the forward GEMMs of #8 (the same
//    engine, csrc/generic_mma.cuh, so both modes give bitwise the same y), in
//    residual mode a load of the saved y; then per layer, last first, the
//    gate VJP (a warp per row, in place over y) and the dm GEMM.  Two y
//    buffers serve any L: a replayed y_l waits in the block's own dy_l rows
//    in global memory (L2-resident) until its VJP, and is read back while the
//    dm GEMM above it runs.  In bf16 every GEMM runs on
//    that engine: mma.sync over only the 16x8 weight tiles that hold a
//    structural nonzero (the forward's tiles for the replay, a second tiling
//    of W^T for dm, components last first for #14), streamed by cp.async.bulk
//    through a 4-stage mbarrier ring that runs across the GEMMs (the next
//    GEMM's tiles load during the gate VJP).  It writes, per slot row, each
//    layer's dy and m_1 .. m_L-1 (for the weight gradients; m_0 only where a
//    kernel reads it: tabled, and #14), the rounded sender cotangent d_hs (tabled:
//    [N*K, F] node-major, for the table sum; untabled: [K, N, F], the
//    kernel's output), and per receiver d_hr.
// 2. wgrad.  dW_l[c] = m_l^T (dy_l attr_c) sums over all N*K slot rows: 1.05
//    MB of fp32 at the lmax=2 config, far more than a block's shared memory,
//    and CUDA blocks run in no order, so there is no carried sum as on the
//    TPU.  Each block owns one (layer, row range, group of G components)
//    and its G output tiles [C1, D] in registers (G = 2 in bf16), and streams
//    its rows' m and dy in chunks of 64 by cp.async (bf16: four buffers,
//    three chunks in flight while one multiplies; fp32 and #14: two): each
//    chunk is read once for all G components.  On the tensor cores both operands come by
//    ldmatrix.trans; each dy fragment is scaled by attr_c in registers, once
//    per component.  Untabled, layer 1's m_0 rows are rebuilt from hs, h and
//    geo2 (bit for bit the chain's m_0: 4-byte cp.async of the two feature
//    rows, d2, zeros), so the chain does not write them.  It writes its tiles
//    into a per-range partial [splits, NW].  No float atomics; the partials
//    are summed in range order by the fixed-order reduction of
//    csrc/fused_message_tab_bwd.cu, so reruns are bit-identical.  For #14 a
//    block owns one (layer, component, backward tile) and writes the tile's
//    rounded partial; a group of tiles (as many partials as fit a fixed
//    budget, 127 at the lmax=2 config) is launched at once, and the reduction
//    adds the group in tile order onto the running sum in its first row: the
//    per-tile partials of a 1M-point backward (13 GB at tile 80) are never
//    all held.
//
// 3. table (tabled only).  One block per gather tile sums each table entry's
//    d_hs rows in slot order (a counting sort of loc in shared memory): d_hu.
// fp32 (the check path) runs the GEMMs on the FMA units, dense.  Widths are
// runtime arguments, any that fit a block's shared memory: the chain's GEMMs
// walk their columns in blocks (generic_mma.cuh: 128 of D, 192 of C1), the
// gate VJP any row width (the direct branch parked in the other y buffer),
// the FMA GEMMs their work items in passes (their weight slice staged where
// it fits, else read from global memory; fp32 chain blocks of 32 or 16 rows
// where 64 do not fit), and each weight-gradient block one window of at most
// 192 x 128 of dW_l[c] (its rows' m and dy columns of that window only).
// The chain keeps the geometry in the data type in shared memory, so A = 36
// (lmax_attr = 5, 38 values per slot) fits a block at the lmax=2 widths.
//
// Work and bound.  Per valid slot the function needs 2 x the folded nonzeros
// for the dW and the dm products (#9: 120,960 flops at the lmax=2 config) and
// once more for the replay (#10, #13, #14: 181,440); the chain multiplies
// the listed tiles (182,016 flops a slot for the replay, 173,568 for dm),
// the weight gradients are dense (dW' is written everywhere, 526,824 flops a
// slot; #14's twice, dya = hi + lo).  #9 also reads the saved ys (1.7 GB at
// 250k points in bf16), so it is bound by bytes; #10 by operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gate_act.cuh"
#include "generic_mma.cuh"

// GENERIC_WGRAD_CLOCKS (a profiling build of kernels/generic_ab.py, never the
// package's library): thread 0 of each weight-gradient block adds the
// cycles spent waiting for each chunk and multiplying it to wgrad_cycles[].
#ifdef GENERIC_WGRAD_CLOCKS
__device__ unsigned long long wgrad_cycles[4];
#define WG_CLOCK(i)                                                                   \
  do {                                                                                \
    if (threadIdx.x == 0) {                                                           \
      const long long now = clock64();                                                \
      atomicAdd(&wgrad_cycles[i], (unsigned long long)(now - wg_t0));                 \
      wg_t0 = now;                                                                    \
    }                                                                                 \
  } while (0)
#else
#define WG_CLOCK(i) \
  do {              \
  } while (0)
#endif

namespace {

using gmma::mma_bf16_16816;

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;        // weight gradients, table sum; the chain in fp32
constexpr int kWarps = kThreads / 32;  // the most warps of a block
constexpr int kThreadsChainMma = 128;  // chain, bf16: 4 warps x 16 rows, two blocks an SM
constexpr int kRowsMma = 64;
constexpr int kRowsFma = 64;   // chain, fp32
constexpr int kScratchD = 128;       // gate VJP: the least width of a warp's scratch row
constexpr int kRT = 4, kCT = 4;        // FMA engine: rows x columns per work item
constexpr int kItChain = 3;            // FMA chain: work items per thread
constexpr int kItW = 6;                // FMA wgrad: work items per thread
constexpr int kChunk = 64;             // wgrad: slot rows per chunk
constexpr int kWMT = 3, kWNT = 8;      // wgrad mma: m-tiles x n-tiles per warp
constexpr int kWinM = 4 * kWMT * 16;   // wgrad: a block's window of dW_l[c], 192 rows (C1) ...
constexpr int kWinN = 2 * kWNT * 8;    // ... by 128 columns (D); fma: 6 x 256 4x4 items
constexpr int kGroup = 2;              // wgrad, bf16: attribute components per block
constexpr int kWgradBufs = 4;          // wgrad, bf16: chunks in shared memory (3 in flight)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// x rounded to the data type and widened back to fp32
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

// the forward's sigmoid (kernel #8): the fast exponential, a correctly
// rounded reciprocal
__device__ __forceinline__ float sigmoid_f(float x) { return __frcp_rn(1.0f + __expf(-x)); }

using gmma::cp_async16;
using gmma::cp_async_commit;
using gmma::cp_async_wait;
using gmma::ldsm_x2_t;
using gmma::ldsm_x4_t;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline long align16(long bytes) { return (bytes + 15) / 16 * 16; }

struct Dims {
  int n, f, k, a, tile, u;
  int nl;          // message layers
  int dk_last;     // the cotangent's width (the last layer's gate outputs)
  int rows, rb;    // chain: slot rows per block, receivers per block
  int ldm;         // m / dm row stride (elements)
  int ldy;         // y / dy row stride (elements)
  int lsc;         // gate VJP: a warp's scratch row (floats)
  int ldw, wbuf;   // fp32: weight-slice row stride, elements per weight buffer
  int nbuf;        // fp32: one weight buffer (bf16: none, the engine's ring)
  int gs;          // geometry per slot: a + 2
  int gate_ints;   // chain: every layer's selections and inverse tables (2 dk + D + 1 each)
  long nw;         // weight-gradient entries of every layer: A sum C1 D
  int splits;      // wgrad: row ranges
  int ldz;         // wgrad: dya row stride (a window's)
  int wldm;        // wgrad: m row stride (a window's)
  int nwin;        // wgrad: windows of the widest layer's dW_l[c]
  int trows, tile0;  // wgrad, per tile (#14): slot rows per tile, the first tile
  int stages;        // chain, bf16: the depth of the engine's ring
  int nmasks;        // chain, bf16: the plan's masks (A x (C1/16 + D/16) x blocks per layer)
};

// w3: the layers' (C1, D, dk), nl of them (host memory)
__host__ __device__ inline Dims make_dims(bool mma, int n, int f, int k, int a, int tile, int u,
                                          int nl, const int* w3) {
  Dims d;
  d.n = n; d.f = f; d.k = k; d.a = a; d.tile = tile; d.u = u;
  d.nl = nl;
  int c1max = 0, dmax = 0, steps = 0;
  d.gate_ints = 0;
  d.nw = 0;
  d.nwin = 1;
  for (int l = 0; l < nl; ++l) {
    const int c1 = w3[3 * l], dd = w3[3 * l + 1], dk = w3[3 * l + 2];
    c1max = c1 > c1max ? c1 : c1max;
    dmax = dd > dmax ? dd : dmax;
    steps += (c1 + 15) / 16 * gmma::fwd_blocks(dd) + (dd + 15) / 16 * gmma::dm_blocks(c1);
    const int win =
        (round_up(c1, 16) + kWinM - 1) / kWinM * ((round_up(dd, 16) + kWinN - 1) / kWinN);
    d.nwin = win > d.nwin ? win : d.nwin;
    d.gate_ints += 2 * dk + dd + 1;
    d.nw += (long)a * c1 * dd;
  }
  d.dk_last = nl > 0 ? w3[3 * nl - 1] : 0;
  d.rows = mma ? kRowsMma : kRowsFma;
  d.rb = k > 0 ? d.rows / k : 0;
  // row strides: 16-byte rows whose 16-byte count is odd (conflict-free
  // fragment loads and ldmatrix)
  d.ldm = round_up(c1max, 16) + 8;
  d.ldy = round_up(dmax, 16) + 8;
  d.lsc = dmax > kScratchD ? round_up(dmax, 32) : kScratchD;
  d.wldm = (round_up(c1max, 16) < kWinM ? round_up(c1max, 16) : kWinM) + 8;
  d.ldz = (round_up(dmax, 16) < kWinN ? round_up(dmax, 16) : kWinN) + 8;
  if (mma) {
    d.ldw = 0;                         // the weights stream through the engine's ring
    d.wbuf = 0;
    d.nbuf = 0;
  } else {
    d.ldw = round_up(dmax, 4);         // slices [C1][ldw], D contiguous (nbuf 0: read
    d.wbuf = c1max * d.ldw;            // from global memory)
    d.nbuf = 1;
  }
  d.gs = a + 2;
  d.splits = 1;
  d.trows = 0;
  d.tile0 = 0;
  d.stages = 0;
  d.nmasks = a * steps;
  return d;
}

// chain shared memory: geometry, ints (senders, receivers, every layer's
// selections and inverse tables), the per-warp gate scratch, m, and two y
// buffers (the layer whose VJP runs and the one below it, whose y comes
// back from global memory while the dm product runs), weights
__host__ __device__ inline long chain_ints(const Dims& d) { return 2L * d.rows + d.gate_ints; }
template <typename T>
__host__ __device__ inline long chain_rows_smem(const Dims& d) {
  return align16((long)sizeof(T) * d.rows * d.gs) + align16(4L * chain_ints(d)) +
         align16(4L * kWarps * d.lsc) + align16((long)sizeof(T) * d.rows * d.ldm) +
         2 * align16((long)sizeof(T) * d.rows * d.ldy);
}
// bf16: as deep a ring as leaves two blocks an SM beside the rows and the
// plan's tables
__host__ __device__ inline int chain_stages(const Dims& d) {
  return gmma::ring_stages(chain_rows_smem<bf16>(d) + gmma::table_bytes(d.nmasks));
}
template <typename T>
__host__ __device__ inline long chain_smem(const Dims& d) {
  return chain_rows_smem<T>(d) +
         (sizeof(T) == 2 ? gmma::ring_bytes(chain_stages(d)) + gmma::table_bytes(d.nmasks)
                         : align16((long)sizeof(T) * d.nbuf * d.wbuf));
}
// nbufs chunks of m and dy rows and of attributes (per tile, #14: one more
// dya buffer, the low halves of dya in bf16)
template <typename T>
__host__ __device__ inline long wgrad_smem(const Dims& d, int nbufs, bool tiles) {
  return nbufs * align16((long)sizeof(T) * kChunk * d.wldm) +
         (nbufs + (tiles ? 1 : 0)) * align16((long)sizeof(T) * kChunk * d.ldz) +
         4L * nbufs * kChunk * kGroup + 16;  // attributes, the window
}

// ---------------------------------------------------------------------------
// GEMM engines.  Each starts with a block barrier (its inputs complete, the
// weight buffers free) and leaves its output in shared memory.

// The bf16 products on the engine of generic_mma.cuh, over the weight
// stream of the ring (the plan's masks of that GEMM at masks).  Each starts
// with a block barrier (its input rows complete) and writes its bf16 output
// into shared memory.

// y = sum_c attr_c * (M @ W[c]), one column block of D at a time, rounded
// to bf16 into Y (columns up to D rounded to 16; the pad is zero): the
// arithmetic of kernel #8's layer_mma, so the replay gives bitwise the
// forward's y.
__device__ void layer_fwd_mma(gmma::Ring& ring, int stream, const uint32_t* masks, int c1,
                              int dd, const Dims& d, const bf16* M, bf16* Y, const bf16* geo) {
  constexpr int NT = gmma::kBlockNT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const int nt_n = round_up(dd, 16) / 8, ks_n = (c1 + 15) / 16, nb = gmma::fwd_blocks(dd);
  __syncthreads();
  gmma::Cursor cur = gmma::open(ring, stream);
  for (int b = 0; b < nb; ++b) {
    float acc[NT][4];
    gmma::gemm_fwd<NT>(ring, cur, masks + b * d.a * ks_n, d.a, ks_n, M, d.ldm, geo, d.gs, acc);
    if (b + 1 == nb) gmma::close(ring, cur, lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (b * NT + nt < nt_n) {
        const int col = (b * NT + nt) * 8 + t4 * 2;
        *reinterpret_cast<__nv_bfloat162*>(Y + (r0 + g) * d.ldy + col) =
            __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<__nv_bfloat162*>(Y + (r0 + g + 8) * d.ldy + col) =
            __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
      }
    }
  }
}

// dm = sum_c (dy * attr_c, rounded to bf16) @ W[c]^T, one column block of C1
// at a time, rounded to bf16 into Out (columns up to C1 rounded to 8); with
// VJP kernel #14's rounding (gmma::gemm_dm_vjp: per component dm_c rounded,
// added in bf16, last first).
template <bool VJP>
__device__ void layer_bwd_mma(gmma::Ring& ring, int stream, const uint32_t* masks, int c1,
                              int dd, const Dims& d, const bf16* DY, bf16* Out, const bf16* geo) {
  constexpr int CT = gmma::kBlockCT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const int ct_n = (c1 + 7) / 8, ds_n = round_up(dd, 16) / 16, nb = gmma::dm_blocks(c1);
  __syncthreads();
  gmma::Cursor cur = gmma::open(ring, stream);
  for (int b = 0; b < nb; ++b) {
    float acc[CT][4];
    const uint32_t* mb = masks + b * d.a * ds_n;
    if constexpr (VJP)
      gmma::gemm_dm_vjp<CT>(ring, cur, mb, d.a, ds_n, DY, d.ldy, geo, d.gs, acc);
    else
      gmma::gemm_dm<CT>(ring, cur, mb, d.a, ds_n, DY, d.ldy, geo, d.gs, acc);
    if (b + 1 == nb) gmma::close(ring, cur, lane);
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) {
      if (b * CT + ct < ct_n) {
        const int col = (b * CT + ct) * 8 + t4 * 2;
        *reinterpret_cast<__nv_bfloat162*>(Out + (r0 + g) * d.ldm + col) =
            __floats2bfloat162_rn(acc[ct][0], acc[ct][1]);
        *reinterpret_cast<__nv_bfloat162*>(Out + (r0 + g + 8) * d.ldm + col) =
            __floats2bfloat162_rn(acc[ct][2], acc[ct][3]);
      }
    }
  }
}

// the natural-layout slice W[c] [C1][D] into Ws [C1][ldw], zero past D
// (staged: d.nbuf > 0), or nothing (the FMA GEMMs read W[c] from global
// memory); between two block barriers
template <typename T>
__device__ __forceinline__ void stage_slice_fma(const T* __restrict__ W, int c, int c1, int dd,
                                                const Dims& d, T* Ws) {
  if (d.nbuf == 0) return;
  const T* Wc = W + (long)c * c1 * dd;
  for (int idx = threadIdx.x; idx < c1 * d.ldw; idx += blockDim.x) {
    const int kk = idx / d.ldw, nn = idx % d.ldw;
    Ws[idx] = nn < dd ? Wc[(long)kk * dd + nn] : from_f<T>(0.f);
  }
}

// W[c][kk][nn] from the staged slice, or from global memory; zero past D
template <typename T>
__device__ __forceinline__ float w_at(const T* __restrict__ W, const T* Ws, int c, int c1, int dd,
                                      int kk, int nn, const Dims& d) {
  if (d.nbuf > 0) return to_f(Ws[kk * d.ldw + nn]);
  return nn < dd ? to_f(W[((long)c * c1 + kk) * dd + nn]) : 0.f;
}

// y = sum_c attr_c * (M @ W[c]) on the FMA units, the arithmetic of kernel
// #8's layer_fma (the sum over c in registers here), rounded into Y (columns
// up to D rounded to 16; the pad is zero).  The work items go in passes of
// kItChain per thread (one pass up to D = 192 at 64 rows).
template <typename T>
__device__ void layer_fwd_fma(const T* __restrict__ W, int c1, int dd, const Dims& d,
                              const T* M, T* Ws, T* Y, const T* geo) {
  const int cg_n = (dd + kCT - 1) / kCT;
  const int items = (d.rows / kRT) * cg_n;
  for (int base = 0; base < items; base += kItChain * blockDim.x) {
    float y[kItChain][kRT][kCT];
#pragma unroll
    for (int it = 0; it < kItChain; ++it)
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int j = 0; j < kCT; ++j) y[it][i][j] = 0.f;
    for (int c = 0; c < d.a; ++c) {
      __syncthreads();
      stage_slice_fma<T>(W, c, c1, dd, d, Ws);
      __syncthreads();
#pragma unroll
      for (int it = 0; it < kItChain; ++it) {
        const int item = base + threadIdx.x + it * blockDim.x;
        if (item < items) {
          const int r0 = (item / cg_n) * kRT, j0 = (item % cg_n) * kCT;
          float t[kRT][kCT];
#pragma unroll
          for (int i = 0; i < kRT; ++i)
#pragma unroll
            for (int j = 0; j < kCT; ++j) t[i][j] = 0.f;
          for (int kk = 0; kk < c1; ++kk) {
            float w[kCT];
#pragma unroll
            for (int j = 0; j < kCT; ++j) w[j] = w_at<T>(W, Ws, c, c1, dd, kk, j0 + j, d);
#pragma unroll
            for (int i = 0; i < kRT; ++i) {
              const float x = to_f(M[(r0 + i) * d.ldm + kk]);
#pragma unroll
              for (int j = 0; j < kCT; ++j) t[i][j] = fmaf(x, w[j], t[i][j]);
            }
          }
#pragma unroll
          for (int i = 0; i < kRT; ++i) {
            const float at = to_f(geo[(r0 + i) * d.gs + c]);
#pragma unroll
            for (int j = 0; j < kCT; ++j)
              y[it][i][j] = c == 0 ? __fmul_rn(at, t[i][j])
                                   : __fadd_rn(y[it][i][j], __fmul_rn(at, t[i][j]));
          }
        }
      }
    }
#pragma unroll
    for (int it = 0; it < kItChain; ++it) {
      const int item = base + threadIdx.x + it * blockDim.x;
      if (item < items) {
        const int r0 = (item / cg_n) * kRT, j0 = (item % cg_n) * kCT;
#pragma unroll
        for (int i = 0; i < kRT; ++i)
#pragma unroll
          for (int j = 0; j < kCT; ++j) Y[(r0 + i) * d.ldy + j0 + j] = from_f<T>(y[it][i][j]);
      }
    }
  }
  const int dpl = round_up(dd, 16);
  for (int w = threadIdx.x; w < d.rows * dpl; w += blockDim.x) {  // zero pad past D4
    const int r = w / dpl, j = w % dpl;
    if (j >= cg_n * kCT) Y[r * d.ldy + j] = from_f<T>(0.f);
  }
}

// dm = sum_c (dy * attr_c, rounded) @ W[c]^T on the FMA units, rounded into
// Out (columns up to C1 rounded to 4); the work items in passes as above.
template <typename T>
__device__ void layer_bwd_fma(const T* __restrict__ W, int c1, int dd, const Dims& d,
                              const T* DY, T* Ws, T* Out, const T* geo) {
  const int cq_n = (c1 + kCT - 1) / kCT;
  const int items = (d.rows / kRT) * cq_n;
  for (int base = 0; base < items; base += kItChain * blockDim.x) {
    float acc[kItChain][kRT][kCT];
#pragma unroll
    for (int it = 0; it < kItChain; ++it)
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int j = 0; j < kCT; ++j) acc[it][i][j] = 0.f;
    for (int c = 0; c < d.a; ++c) {
      __syncthreads();
      stage_slice_fma<T>(W, c, c1, dd, d, Ws);
      __syncthreads();
#pragma unroll
      for (int it = 0; it < kItChain; ++it) {
        const int item = base + threadIdx.x + it * blockDim.x;
        if (item < items) {
          const int r0 = (item / cq_n) * kRT, k0 = (item % cq_n) * kCT;
          float at[kRT];
#pragma unroll
          for (int i = 0; i < kRT; ++i) at[i] = to_f(geo[(r0 + i) * d.gs + c]);
          for (int dd_ = 0; dd_ < dd; ++dd_) {
            float z[kRT], w[kCT];
#pragma unroll
            for (int i = 0; i < kRT; ++i)
              z[i] = rnd<T>(__fmul_rn(to_f(DY[(r0 + i) * d.ldy + dd_]), at[i]));
#pragma unroll
            for (int j = 0; j < kCT; ++j)
              w[j] = k0 + j < c1 ? w_at<T>(W, Ws, c, c1, dd, k0 + j, dd_, d) : 0.f;
#pragma unroll
            for (int i = 0; i < kRT; ++i)
#pragma unroll
              for (int j = 0; j < kCT; ++j) acc[it][i][j] = fmaf(z[i], w[j], acc[it][i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int it = 0; it < kItChain; ++it) {
      const int item = base + threadIdx.x + it * blockDim.x;
      if (item < items) {
        const int r0 = (item / cq_n) * kRT, k0 = (item % cq_n) * kCT;
#pragma unroll
        for (int i = 0; i < kRT; ++i)
#pragma unroll
          for (int j = 0; j < kCT; ++j) Out[(r0 + i) * d.ldm + k0 + j] = from_f<T>(acc[it][i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The gate and its VJP (Gate.fast_apply: out_j = y_j * sigmoid(y)[sel_j]).

// the forward gate of lane j from a row of y in the data type (kernel #8's
// gate_out: under another activation than silu a scalar lane, sel[j] == j,
// is rnd(act(y_j)))
template <typename T, int ACT = gact::kAct>
__device__ __forceinline__ float gate_out(const T* yrow, const int* sel, int j) {
  if constexpr (ACT != gact::kSilu) {
    if (sel[j] == j) return rnd<T>(gact::act_f<ACT>(to_f(yrow[j])));
  }
  const float s = rnd<T>(sigmoid_f(to_f(yrow[sel[j]])));
  return rnd<T>(__fmul_rn(to_f(yrow[j]), s));
}

// Per row (a warp each), dy over y in place, as JAX's AD differentiates
// fast_apply in the data type:
//   direct_j = rnd(dout_j * mult_j),  dmlt_j = rnd(dout_j * y_j)          (j < dk)
//   dsg_s    = rnd(fp32 sum of dmlt_j over the lanes j with sel_j = s)
//   dsig_s   = rnd(dsg_s * (sig_s * (1 - sig_s))),  sig_s = sigmoid(y_s) in fp32
//   dy_s     = rnd(direct_s + dsig_s) for s < dk, dsig_s after; zero to dpad.
// Under another activation (ACT != silu) as JAX's AD differentiates the
// concat-form gate, Gate.__call__:
//   dy_j     = rnd(act_vjp(y_j, dout_j)) on a scalar lane (sel_j = j),
//              direct_j on a gated lane (j < dk);
//   dsg_s    = the cotangent of gate s's concatenated copies, dmlt_j over the
//              lanes j with sel_j = s in component (ascending lane) order,
//              each partial sum rounded to the data type (JAX's backward pass
//              adds a variable's cotangents one at a time, and XLA rounds
//              each add in bf16: not the fp32 sum above);
//   dy_s     = rnd(dsg_s * (sig_s * (1 - sig_s))) for s >= dk.
// invs/invl: for each sigmoid lane s, the lanes j (ascending) with sel_j = s.
// The direct branch (a value of the data type) waits in the same row of Dir,
// a free [rows][ldy] buffer, between the two passes: each lane reads back
// only its own columns, so the row may be any width.
template <typename T, typename Dout, int ACT = gact::kAct>
__device__ void gate_vjp(T* Y, T* Dir, int dd, int dk, const int* sel, const int* invs,
                         const int* invl, float* scratch, const Dims& d, Dout dout) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* dml = scratch + warp * d.lsc;
  const int dpad = round_up(dd, 16);
  for (int r = warp; r < d.rows; r += blockDim.x >> 5) {
    T* y = Y + r * d.ldy;
    T* direct = Dir + r * d.ldy;
    for (int j = lane; j < dk; j += 32) {
      const float o = dout(r, j);
      const int sj = sel[j];
      float dj;
      if (ACT != gact::kSilu && sj == j) {
        dj = rnd<T>(gact::act_vjp<ACT>(to_f(y[j]), o));
      } else {
        const float m = rnd<T>(sigmoid_f(to_f(y[sj])));
        dj = rnd<T>(__fmul_rn(o, m));
      }
      direct[j] = from_f<T>(dj);
      dml[j] = rnd<T>(__fmul_rn(o, to_f(y[j])));
    }
    __syncwarp();
    for (int s = lane; s < dpad; s += 32) {
      float v = 0.f;
      if (s < dd) {
        if (ACT == gact::kSilu || s >= dk) {
          float sum = 0.f;
          if constexpr (ACT == gact::kSilu) {
            for (int p = invs[s]; p < invs[s + 1]; ++p) sum = __fadd_rn(sum, dml[invl[p]]);
          } else {
            for (int p = invs[s]; p < invs[s + 1]; ++p)
              sum = rnd<T>(__fadd_rn(sum, dml[invl[p]]));
          }
          const float sg = sigmoid_f(to_f(y[s]));
          const float dsig = rnd<T>(__fmul_rn(rnd<T>(sum), __fmul_rn(sg, __fsub_rn(1.f, sg))));
          v = s < dk ? rnd<T>(__fadd_rn(to_f(direct[s]), dsig)) : dsig;
        } else {
          v = to_f(direct[s]);
        }
      }
      y[s] = from_f<T>(v);
    }
    __syncwarp();
  }
}

// the inverse selection of one layer: counts in parallel, the prefix sum
// on one thread, the lists in parallel (each in ascending lane order)
__device__ void build_inverse(const int* sel, int dk, int dd, int* invs, int* invl) {
  for (int s = threadIdx.x; s < dd; s += blockDim.x) {
    int cnt = 0;
    for (int j = 0; j < dk; ++j) cnt += sel[j] == s;
    invs[s + 1] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    invs[0] = 0;
    for (int s = 0; s < dd; ++s) invs[s + 1] += invs[s];
  }
  __syncthreads();
  for (int s = threadIdx.x; s < dd; s += blockDim.x) {
    int p = invs[s];
    for (int j = 0; j < dk; ++j)
      if (sel[j] == s) invl[p++] = j;
  }
}

// layer-1 input row [hs_s || h_r || d2] into mrow, zero-padded to width (a
// warp per row; s, rn < 0: zero rows).  bf16 rows of even width go by 4-byte
// cp.async (the caller waits for them before its block barrier).
template <typename T>
__device__ __forceinline__ void m0_row(const T* __restrict__ hs, const T* __restrict__ h, int f,
                                       int s, int rn, float d2, T* mrow, int width, int lane) {
  if constexpr (sizeof(T) == 2) {
    if (f % 2 == 0) {
      gmma::gather_row(mrow, s >= 0 ? hs + (long)s * f : nullptr, f, lane);
      gmma::gather_row(mrow + f, rn >= 0 ? h + (long)rn * f : nullptr, f, lane);
      for (int j = 2 * f + lane; j < width; j += 32) mrow[j] = from_f<T>(j == 2 * f ? d2 : 0.f);
      return;
    }
  }
  for (int j = lane; j < f; j += 32) {
    const T xs = s >= 0 ? hs[(long)s * f + j] : from_f<T>(0.f);
    const T xr = rn >= 0 ? h[(long)rn * f + j] : from_f<T>(0.f);
    mrow[j] = xs;
    mrow[f + j] = xr;
  }
  for (int j = 2 * f + lane; j < width; j += 32) mrow[j] = from_f<T>(j == 2 * f ? d2 : 0.f);
}

// the sender node of slot e (receiver node, slot kk), or -1
__device__ __forceinline__ int sender_of(const int* __restrict__ loc, const int* __restrict__ gtab,
                                         int node, long e, const Dims& d) {
  const int l = loc[e];
  if (l >= d.u) return -1;
  const int t = gtab[(long)(node / d.tile) * d.u + l];
  return (t >= 0 && t < d.n) ? t : -1;
}

// rows [rows][ld] of shared memory into out [N*K][width] (width and ld
// multiples of 16 bytes), rows of real receivers only, 16 bytes per thread
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ out, int width, const T* src, int ld,
                                           const int* rnode, long e0, const Dims& d) {
  constexpr int V = 16 / sizeof(T);
  const int nv = width / V;
  for (int w = threadIdx.x; w < d.rows * nv; w += blockDim.x) {
    const int r = w / nv, q = (w % nv) * V;
    if (rnode[r] >= 0)
      *reinterpret_cast<uint4*>(out + (e0 + r) * width + q) =
          *reinterpret_cast<const uint4*>(src + r * ld + q);
  }
}

// one layer's y rows (dd wide, lds elements apart in global memory from the
// block's first slot row e0) into Y [rows][ldy]: 4-byte cp.async where the
// rows align (the caller waits, cp_async_wait_all, then its block barrier),
// else plain loads; rows past the receivers are zero (only columns < dd are
// read before the gate VJP writes the row)
template <typename T>
__device__ void load_y_rows(T* Y, const T* __restrict__ src, int dd, int lds, const int* rnode,
                            long e0, const Dims& d) {
  constexpr int E = sizeof(T) == 4 ? 1 : 2;  // elements per 4-byte word
  const bool words = E == 1 || (dd % 2 == 0 && lds % 2 == 0);
  const int per = words ? dd / E : dd;
  const int step = words ? E : 1;
  for (int w = threadIdx.x; w < d.rows * per; w += blockDim.x) {
    const int r = w / per, j = (w % per) * step;
    T* dst = Y + r * d.ldy + j;
    if (rnode[r] < 0) {
      dst[0] = from_f<T>(0.f);
      if (step == 2) dst[1] = from_f<T>(0.f);
    } else if (words) {
      gmma::cp_async4(dst, src + (e0 + r) * lds + j);
    } else {
      dst[0] = src[(e0 + r) * lds + j];
    }
  }
}

// 1. The chain: kernel #9 (Mode::kResidual) and #10 (Mode::kReplay) with TAB
// (senders through loc/gtab, rows of h; d_hs node-major), #12, #13 and #14
// (Mode::kVjp) without (slot k of receiver i reads row k*N + i of hs [K, N, F]
// and writes d_hs there).  kVjp replays as kReplay and differs in the dm
// GEMMs' rounding (gmma::gemm_dm_vjp); in fp32 that rounding is the identity,
// so the fp32 instance of kVjp is kReplay's.  bf16 weight streams, in the
// order the chain takes them: every layer's forward tiles, first to last
// (replay modes only), then the dm tiles, last layer first.
//
// Any number of layers L, two y buffers: the forward pass (the replay of
// kernel #8's layers, or the saved ys read back) keeps only the layer at
// hand; in replay modes each y_l but the last is parked in the block's own
// rows of dy_l in global memory (the rows the VJP later overwrites with
// dy_l), and the backward reads y_l-1 back into the other buffer while
// layer l's dm product runs.  Shared memory does not grow with L but for the
// gate tables (2 dk + D + 1 ints a layer) and the plan's masks.
//
// w (fp32): the layers' flat weights; sel: the layers' selections; layers:
// the wrapper's layer table; yin (#9, #12): the saved ys, the layers' [N*K,
// D_l] one after the other; dy: every layer's dy rows [N*K, D_l rounded up to
// 8], one after the other; m0g: null (the untabled weight gradients of #12 /
// #13 rebuild m_0) or m_0 [N*K, C1_0 rounded up to 16]; mg: m_1 .. m_L-1
// likewise, one after the other.
enum class Mode { kResidual, kReplay, kVjp };

template <typename T, bool MMA, Mode MODE, bool TAB>
__global__ void __launch_bounds__(MMA ? kThreadsChainMma : kThreads, MMA ? 2 : 1)
chain_kernel(const T* __restrict__ hs, const T* __restrict__ h, const T* __restrict__ geo2,
             const int* __restrict__ loc, const int* __restrict__ gtab,
             const T* __restrict__ w, const int* __restrict__ selg,
             const int* __restrict__ layers, const T* __restrict__ yin,
             const T* __restrict__ dagg, T* __restrict__ dhs, T* __restrict__ dhr,
             T* __restrict__ dyg, T* __restrict__ m0g, T* __restrict__ mg,
             const bf16* __restrict__ wpk, const uint32_t* __restrict__ masks,
             const int* __restrict__ chunks, int nstreams, int nq, Dims d) {
  using gmma::layer_field;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* p = smem_raw;
  T* geo = reinterpret_cast<T*>(p);  // [rows][a+2]: attr, d2, mask
  p += align16((long)sizeof(T) * d.rows * d.gs);
  int* snd = reinterpret_cast<int*>(p);
  int* rnode = snd + d.rows;
  int* gates = rnode + d.rows;  // per layer at kGateOff: sel [dk], invs [D + 1], invl [dk]
  p += align16(4L * chain_ints(d));
  float* scratch = reinterpret_cast<float*>(p);  // [warps][lsc]
  p += align16(4L * kWarps * d.lsc);
  T* M = reinterpret_cast<T*>(p);  // [rows][ldm]: m, then dm
  p += align16((long)sizeof(T) * d.rows * d.ldm);
  T* Yc = reinterpret_cast<T*>(p);  // [rows][ldy]: the current layer's y, then its dy
  p += align16((long)sizeof(T) * d.rows * d.ldy);
  T* Yo = reinterpret_cast<T*>(p);  // [rows][ldy]: the layer below's y, read back
  p += align16((long)sizeof(T) * d.rows * d.ldy);
  T* Wsl = reinterpret_cast<T*>(p);  // fp32: one component's weight slice
  constexpr bool kReplays = MODE != Mode::kResidual;
  gmma::Ring ring;  // bf16: the engine's ring of weight tiles
  // bf16: the plan's masks (every layer's forward masks, then every layer's
  // dm masks), then its chunk table, in shared memory past the ring
  uint32_t* masks_s = reinterpret_cast<uint32_t*>(p + gmma::ring_bytes(chain_stages(d)));
  if constexpr (MMA) {
    gmma::load_tables(masks, d.nmasks, chunks + nstreams + 1, nq, masks_s);
    __syncthreads();
    ring.setup(p, chain_stages(d), wpk, reinterpret_cast<const int*>(masks_s + d.nmasks),
               chunks, nq);
    ring.start(blockDim.x >> 5);  // the first GEMM's tiles load during the gathers
  }
  const int nl = d.nl;
  // the stream of each GEMM: layer l's forward l (replay modes), its dm
  // product after every forward, last layer first
  auto dm_stream = [&](int l) { return (kReplays ? nl : 0) + nl - 1 - l; };

  const int node0 = blockIdx.x * d.rb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a = d.a, f = d.f;
  for (int l = 0; l < nl; ++l) {
    const int dk = layer_field(layers, l, gmma::kDk);
    const int* sl = selg + layer_field(layers, l, gmma::kSelOff);
    int* gs = gates + layer_field(layers, l, gmma::kGateOff);
    for (int j = threadIdx.x; j < dk; j += blockDim.x) gs[j] = sl[j];
  }
  // ---- per-row receiver, sender and geometry
  for (int r = threadIdx.x; r < d.rows; r += blockDim.x) {
    const int node = node0 + r / d.k;
    int s = -1, rn = -1;
    if (r < d.rb * d.k && node < d.n) {
      rn = node;
      const long e = (long)node * d.k + r % d.k;
      if constexpr (TAB) s = sender_of(loc, gtab, node, e, d);
      else s = (r % d.k) * d.n + node;  // the host checks K*N < 2^31
    }
    snd[r] = s;
    rnode[r] = rn;
  }
  {  // the block's geometry: its slot rows are contiguous in geo2; a batch
     // of loads a thread before the stores
    const int nreal = (d.n - node0 < d.rb ? d.n - node0 : d.rb) * d.k * d.gs;
    const T* g = geo2 + (long)node0 * d.k * d.gs;
    constexpr int kBatch = 8;
    for (int w0 = threadIdx.x; w0 < d.rows * d.gs; w0 += kBatch * blockDim.x) {
      T v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int w = w0 + u * blockDim.x;
        v[u] = w < nreal ? g[w] : from_f<T>(0.f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (w0 + u * blockDim.x < d.rows * d.gs) geo[w0 + u * blockDim.x] = v[u];
    }
  }
  __syncthreads();
  for (int l = 0; l < nl; ++l) {
    const int dd = layer_field(layers, l, gmma::kD), dk = layer_field(layers, l, gmma::kDk);
    int* gs = gates + layer_field(layers, l, gmma::kGateOff);
    build_inverse(gs, dk, dd, gs + dk, gs + dk + dd + 1);
  }
  const long e0 = (long)node0 * d.k;  // the block's first slot row
  const long nk = (long)d.n * d.k;    // slot rows of one layer's per-slot buffer
  // ---- m_0 of every slot row, for the weight-gradient kernel where it
  // reads m_0 (tabled, #14); then the forward: each layer's y (replayed as
  // kernel #8 computes it, or read back from the saved ys), its gate into
  // the next layer's m rows (for the weight-gradient kernel)
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < d.rows; r += nwarps)
    m0_row<T>(hs, h, f, snd[r], rnode[r], to_f(geo[r * d.gs + a]), M + r * d.ldm, d.ldm - 8,
              lane);
  if (sizeof(T) == 2 && f % 2 == 0) gmma::cp_async_wait_all();
  __syncthreads();
  if (m0g != nullptr)
    store_rows<T>(m0g, round_up(layer_field(layers, 0, gmma::kC1), 16), M, d.ldm, rnode, e0, d);
  for (int l = 0; l < nl; ++l) {
    const int c1 = layer_field(layers, l, gmma::kC1), dd = layer_field(layers, l, gmma::kD);
    if constexpr (kReplays) {
      if constexpr (MMA)
        layer_fwd_mma(ring, l, masks_s + layer_field(layers, l, gmma::kMaskFwd), c1, dd, d, M,
                      Yc, geo);
      else layer_fwd_fma<T>(w + layer_field(layers, l, gmma::kWOff), c1, dd, d, M, Wsl, Yc, geo);
    } else {
      load_y_rows<T>(Yc, yin + nk * layer_field(layers, l, gmma::kYOff), dd, dd, rnode, e0, d);
      gmma::cp_async_wait_all();
    }
    __syncthreads();
    if (l + 1 == nl) break;
    const int dk = layer_field(layers, l, gmma::kDk);
    const int* gs = gates + layer_field(layers, l, gmma::kGateOff);
    if constexpr (kReplays)  // y_l waits in the block's dy_l rows for the backward
      store_rows<T>(dyg + nk * layer_field(layers, l, gmma::kDyOff), round_up(dd, 8), Yc, d.ldy,
                    rnode, e0, d);
    for (int r = warp; r < d.rows; r += nwarps) {
      for (int j = lane; j < d.ldm - 8; j += 32)
        M[r * d.ldm + j] = from_f<T>(j < dk ? gate_out<T>(Yc + r * d.ldy, gs, j) : 0.f);
    }
    __syncthreads();
    store_rows<T>(mg + nk * layer_field(layers, l + 1, gmma::kMOff), round_up(dk, 16), M, d.ldm,
                  rnode, e0, d);
  }
  // ---- the backward, last layer first: dm_L = rnd(d_agg * mask); per layer
  // the gate VJP in place (dy_l), its rows stored, y_l-1 read back into the
  // other buffer while the dm product dy_l -> dm_l-1 runs
  for (int l = nl - 1; l >= 0; --l) {
    const int c1 = layer_field(layers, l, gmma::kC1), dd = layer_field(layers, l, gmma::kD);
    const int dk = layer_field(layers, l, gmma::kDk);
    const int* gs = gates + layer_field(layers, l, gmma::kGateOff);
    if (l + 1 == nl) {
      gate_vjp<T>(Yc, Yo, dd, dk, gs, gs + dk, gs + dk + dd + 1, scratch, d, [&](int r, int j) {
        const int rn = rnode[r];
        return rn < 0 ? 0.f
                      : rnd<T>(__fmul_rn(to_f(dagg[(long)rn * d.dk_last + j]),
                                         to_f(geo[r * d.gs + a + 1])));
      });
    } else {
      gate_vjp<T>(Yc, Yo, dd, dk, gs, gs + dk, gs + dk + dd + 1, scratch, d,
                  [&](int r, int j) { return to_f(M[r * d.ldm + j]); });
    }
    __syncthreads();
    store_rows<T>(dyg + nk * layer_field(layers, l, gmma::kDyOff), round_up(dd, 8), Yc, d.ldy,
                  rnode, e0, d);
    if (l > 0) {  // y_l-1 back: from the saved ys, or from its dy rows (replay)
      const int db = layer_field(layers, l - 1, gmma::kD);
      if constexpr (kReplays)
        load_y_rows<T>(Yo, dyg + nk * layer_field(layers, l - 1, gmma::kDyOff), db,
                       round_up(db, 8), rnode, e0, d);
      else
        load_y_rows<T>(Yo, yin + nk * layer_field(layers, l - 1, gmma::kYOff), db, db, rnode, e0,
                       d);
    }
    if constexpr (MMA)
      layer_bwd_mma<MODE == Mode::kVjp>(ring, dm_stream(l),
                                        masks_s + layer_field(layers, l, gmma::kMaskDm), c1, dd,
                                        d, Yc, M, geo);
    else layer_bwd_fma<T>(w + layer_field(layers, l, gmma::kWOff), c1, dd, d, Yc, Wsl, M, geo);
    if (l > 0) gmma::cp_async_wait_all();
    __syncthreads();
    T* t = Yc;
    Yc = Yo;
    Yo = t;
  }
  // ---- the sender cotangent of every slot, and the receivers' K-sums
  for (int w = threadIdx.x; w < d.rows * f; w += blockDim.x) {
    const int r = w / f, j = w % f;
    if (rnode[r] >= 0) dhs[(TAB ? e0 + r : (long)snd[r]) * f + j] = M[r * d.ldm + j];
  }
  for (int w = threadIdx.x; w < d.rb * f; w += blockDim.x) {
    const int i = w / f, j = w % f;
    if (node0 + i >= d.n) continue;
    float acc = 0.f;
    for (int kk = 0; kk < d.k; ++kk) acc += to_f(M[(i * d.k + kk) * d.ldm + f + j]);
    dhr[(long)(node0 + i) * f + j] = from_f<T>(acc);
  }
}

// ---------------------------------------------------------------------------
// 2. The weight gradients: block (group x window, range, layer) sums m_l^T
// rnd(dy_l attr_c) over its slot rows for the G components c = G group ..
// into one window (at most kWinM x kWinN: rows mw0.., columns nw0..) of the
// fp32 tiles [C1][D] of partials[range] (layer l's W' at kWOff); it reads
// only that window's columns of m and dy (one window: the whole rows).  The chain
// wrote every layer's dy rows and m_1 .. m_L-1 per slot row (and m_0 where
// REBUILD is off); chunks of 64 rows stream in by
// cp.async into NB buffers (NB - 1 chunks load while one multiplies), each
// read once for all G components.  bf16 (G = kGroup): dy stays unscaled
// in shared memory and each B fragment is scaled by attr_c in registers;
// fp32 (G = 1): dy is scaled by attr_c in shared memory.
// REBUILD (untabled, #12 / #13): layer 1's m_0 row of slot e = i*K + k is
// [hs[k*N + i] || h[i] || d2 || 0], built here as the chain builds it.
// TILES (kernel #14, JAX's AD of _layer_tp; G = 1): range sp is the backward
// tile tile0 + sp (trows slot rows), dya = dy_l attr_c stays fp32 and the
// tile's fp32 sum is rounded to the data type, as the TPU kernel's
// per-grid-step dW'.  In bf16 dya (a product of two bf16 values, 16
// significant bits) is split into hi = rnd(dya) and lo = rnd(dya - hi), both
// exact, and each multiplies on the tensor cores: the products stay exact.

// a pair of bf16 (low first) scaled by (s0, s1), each product rounded to bf16
__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float s0, float s1) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  __nv_bfloat162 o = __floats2bfloat162_rn(__fmul_rn(x.x, s0), __fmul_rn(x.y, s1));
  return *reinterpret_cast<uint32_t*>(&o);
}

using gmma::cp_async4;

template <typename T, bool MMA, bool TILES, int G, bool REBUILD>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_kernel(const T* __restrict__ geo2, const T* __restrict__ m0g, const T* __restrict__ mg,
             const T* __restrict__ dyg, const T* __restrict__ hs, const T* __restrict__ h,
             const int* __restrict__ layers, float* __restrict__ partials, Dims d) {
  static_assert(G == 1 || (MMA && !TILES), "groups of components: bf16, one range each");
  constexpr int NB = MMA && !TILES ? kWgradBufs : 2;  // chunk buffers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* p = smem_raw;
  T* Mb = reinterpret_cast<T*>(p);  // [NB][kChunk][wldm]: m_l rows (the window's columns)
  p += NB * align16((long)sizeof(T) * kChunk * d.wldm);
  T* Zb = reinterpret_cast<T*>(p);  // [NB][kChunk][ldz]: dy rows (fp32 / TILES: then scaled)
  p += NB * align16((long)sizeof(T) * kChunk * d.ldz);
  T* Zlo = reinterpret_cast<T*>(p);  // TILES, bf16: [kChunk][ldz] the low halves
  if (TILES) p += align16((long)sizeof(T) * kChunk * d.ldz);
  float* att = reinterpret_cast<float*>(p);  // [NB][kChunk][G]: attr_c per row and component
  int* wgeo = reinterpret_cast<int*>(att + NB * kChunk * G);  // [4]: the window, below

  const int c0 = blockIdx.x / d.nwin * G, sp = blockIdx.y, layer = blockIdx.z;
  const int ng = d.a - c0 < G ? d.a - c0 : G;  // components of this block
  const int c1 = gmma::layer_field(layers, layer, gmma::kC1);
  const int dd = gmma::layer_field(layers, layer, gmma::kD);
  const int kpl = round_up(c1, 16), dpl = round_up(dd, 16);
  const int wnn = (dpl + kWinN - 1) / kWinN;  // this layer's windows: (kpl / kWinM) x wnn
  const int win = blockIdx.x % d.nwin;
  if (win >= (kpl + kWinM - 1) / kWinM * wnn) return;  // past this layer's windows
  const int mw0 = win / wnn * kWinM, nw0 = win % wnn * kWinN;
  const int kp = kpl - mw0 < kWinM ? kpl - mw0 : kWinM;  // the window's m columns
  const int c1w = c1 - mw0 < kWinM ? c1 - mw0 : kWinM, ddw = dd - nw0 < kWinN ? dd - nw0 : kWinN;
  const long rows_total = (long)d.n * d.k;
  const T* mgl = layer ? mg + rows_total * gmma::layer_field(layers, layer, gmma::kMOff) : m0g;
  const T* dy = dyg + rows_total * gmma::layer_field(layers, layer, gmma::kDyOff);
  const int ldgl = round_up(dd, 8);  // dy's global row
  const int ldg = ldgl - nw0 < kWinN ? ldgl - nw0 : kWinN;  // the window's dy columns there
  const bool rebuild = REBUILD && layer == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long r0, r1;  // this block's slot rows
  if constexpr (TILES) {
    r0 = (long)(d.tile0 + sp) * d.trows;
    r1 = r0 + d.trows < rows_total ? r0 + d.trows : rows_total;
  } else {
    const long nch = (rows_total + kChunk - 1) / kChunk;
    r0 = nch * sp / d.splits * kChunk;
    r1 = nch * (sp + 1) / d.splits * kChunk;
    if (r1 > rows_total) r1 = rows_total;
  }
  constexpr bool kSplit = TILES && MMA;            // dya as hi + lo
  constexpr bool kRegScale = MMA && !TILES;        // dy scaled in registers
  const int dplw = dpl - nw0 < kWinN ? dpl - nw0 : kWinN;  // the window's dy columns, padded
  const long mbuf = align16((long)sizeof(T) * kChunk * d.wldm) / sizeof(T);
  const long zbuf = align16((long)sizeof(T) * kChunk * d.ldz) / sizeof(T);
  constexpr int V = 16 / sizeof(T);
  const int f = d.f;
  // m_0 words of 4 bytes per feature row when they align (F even in bf16;
  // a window starts at an even column)
  const bool words = sizeof(T) == 4 || f % 2 == 0;
  constexpr int E = sizeof(T) == 4 ? 1 : 2;  // elements per word
  // the rebuild's window (its first column, its width, the end of its
  // feature columns: features [mw0, fe), d2 at 2F) in shared memory, read
  // back where a row is rebuilt: held in registers through the multiply,
  // the bf16 instance spilled
  if (threadIdx.x == 0) {
    wgeo[0] = mw0;
    wgeo[1] = kp;
    wgeo[2] = mw0 + kp < 2 * f ? mw0 + kp : 2 * f;
  }

  // dy columns past its global row (ldg .. dplw) stay zero in every buffer;
  // rebuilt m_0 rows: the columns past 2F+1 too
  const int nz = kSplit ? NB + 1 : NB;
  for (int w = threadIdx.x; w < nz * kChunk * (dplw - ldg); w += blockDim.x) {
    const int b = w / (kChunk * (dplw - ldg)), x = w % (kChunk * (dplw - ldg));
    T* Z = b < NB ? Zb + b * zbuf : Zlo;
    Z[(x / (dplw - ldg)) * d.ldz + ldg + x % (dplw - ldg)] = from_f<T>(0.f);
  }
  if (rebuild) {
    const int t0 = 2 * f + 1 > mw0 ? 2 * f + 1 - mw0 : 0;  // the window's zero tail
    const int tail = kp > t0 ? kp - t0 : 0;
    for (int w = threadIdx.x; w < NB * kChunk * tail; w += blockDim.x) {
      const int b = w / (kChunk * tail), x = w % (kChunk * tail);
      Mb[b * mbuf + (x / tail) * d.wldm + t0 + x % tail] = from_f<T>(0.f);
    }
  }
  // the chunk of rows from e0 into buffer b: its m and dy rows by cp.async
  // (zero rows past r1), its attributes by plain loads
  auto load_chunk = [&](long e0, int b) {
    T* M = Mb + b * mbuf;
    T* Z = Zb + b * zbuf;
    if (rebuild) {  // a warp per row: [hs[k*N + i] || h[i] || d2] (the tail is zero)
      for (int r = warp; r < kChunk; r += kWarps) {
        const long e = e0 + r;
        const int w0 = wgeo[0], wk = wgeo[1], fe = wgeo[2];
        T* mrow = M + r * d.wldm;  // column j of m_0 at mrow[j - w0]
        if (e < r1) {
          const long node = e / d.k, kk = e % d.k;
          const T* xs = hs + (kk * d.n + node) * f;
          const T* xr = h + node * f;
          // the sender's columns [w0, w0 + ns) and the receiver's [fr, fr + nr),
          // a word (an element) of each per step
          const int fr = w0 > f ? w0 : f;
          const int ns = (fe < f ? fe : f) - w0, nr = fe - fr, nq = ns > nr ? ns : nr;
          T* mr = mrow + fr - w0;
          const T* xw = xs + w0;
          const T* xq = xr + fr - f;
          if (words) {
            for (int q = E * lane; q < nq; q += 32 * E) {
              if (q < ns) cp_async4(mrow + q, xw + q);
              if (q < nr) cp_async4(mr + q, xq + q);
            }
          } else {
            for (int q = lane; q < nq; q += 32) {
              if (q < ns) mrow[q] = xw[q];
              if (q < nr) mr[q] = xq[q];
            }
          }
          if (lane == 0 && 2 * f >= w0 && 2 * f < w0 + wk) mrow[2 * f - w0] = geo2[e * d.gs + d.a];
        } else {
          for (int j = w0 + lane; j <= 2 * f && j < w0 + wk; j += 32) mrow[j - w0] = from_f<T>(0.f);
        }
      }
    } else {
      for (int w = threadIdx.x; w < kChunk * (kp / V); w += blockDim.x) {
        const int r = w / (kp / V), q = (w % (kp / V)) * V;
        if (e0 + r < r1) cp_async16(M + r * d.wldm + q, mgl + (e0 + r) * kpl + mw0 + q);
        else *reinterpret_cast<uint4*>(M + r * d.wldm + q) = make_uint4(0, 0, 0, 0);
      }
    }
    for (int w = threadIdx.x; w < kChunk * (ldg / V); w += blockDim.x) {
      const int r = w / (ldg / V), q = (w % (ldg / V)) * V;
      if (e0 + r < r1) cp_async16(Z + r * d.ldz + q, dy + (e0 + r) * ldgl + nw0 + q);
      else *reinterpret_cast<uint4*>(Z + r * d.ldz + q) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
  };
  // a thread's attribute of the chunk from e0 (row w / G, component w % G),
  // loaded into a register and stored once the current chunk is multiplied
  static_assert(kChunk * G <= kThreads, "one attribute a thread");
  auto load_att = [&](long e0) -> float {
    const int w = threadIdx.x;
    const long e = e0 + w / G;
    return w < kChunk * G && e < r1 && w % G < ng ? to_f(geo2[e * d.gs + c0 + w % G]) : 0.f;
  };

  // mma: warps 4 (C1) x 2 (D); fma: 4 x 4 work items over the window
  const int mt_n = kp / 16, nt_n = dplw / 8;
  const int mtw = (mt_n + 3) / 4, ntw = (nt_n + 1) / 2;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int mq_n = (c1w + 3) / 4, nq_n = (ddw + 3) / 4, items = mq_n * nq_n;
  float acc[G][MMA ? kWMT : kItW][MMA ? kWNT : kRT][MMA ? 4 : kCT];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int x = 0; x < (MMA ? kWMT : kItW); ++x)
#pragma unroll
      for (int y = 0; y < (MMA ? kWNT : kRT); ++y)
#pragma unroll
        for (int z = 0; z < (MMA ? 4 : kCT); ++z) acc[gi][x][y][z] = 0.f;

  __syncthreads();
#ifdef GENERIC_WGRAD_CLOCKS
  long long wg_t0 = clock64();
#endif
  // chunks 0 .. NB-2 first; at chunk i, chunk i + NB - 1 is issued into the
  // buffer that chunk i - 1 used, so NB - 1 chunks are in flight
  for (int j = 0; j < NB - 1; ++j) {
    if (r0 + (long)j * kChunk < r1) {
      load_chunk(r0 + (long)j * kChunk, j);
      const float v = load_att(r0 + (long)j * kChunk);
      if (threadIdx.x < kChunk * G) att[j * kChunk * G + threadIdx.x] = v;
    }
  }
  for (long e0 = r0; e0 < r1; e0 += kChunk) {
    const int i = (int)((e0 - r0) / kChunk);
    const int b = i % NB, bn = (i + NB - 1) % NB;
    const long en = e0 + (long)(NB - 1) * kChunk;
    const bool more = en < r1;
    float att_next = 0.f;
    if (more) {
      load_chunk(en, bn);
      att_next = load_att(en);
      cp_async_wait<NB - 1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the chunk has landed for every thread
    WG_CLOCK(0);      // issuing the next chunk, waiting for this one
    const T* M = Mb + b * mbuf;
    T* Z = Zb + b * zbuf;
    const float* at_b = att + b * kChunk * G;
    if constexpr (!kRegScale) {
      for (int w = threadIdx.x; w < kChunk * ldg; w += blockDim.x) {
        const int r = w / ldg, j = w % ldg;
        const float v = __fmul_rn(to_f(Z[r * d.ldz + j]), at_b[r]);
        Z[r * d.ldz + j] = from_f<T>(v);
        if constexpr (kSplit) Zlo[r * d.ldz + j] = from_f<T>(__fsub_rn(v, rnd<T>(v)));
      }
      __syncthreads();
    }
    if constexpr (MMA) {
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        uint32_t af[kWMT][4];
#pragma unroll
        for (int mi = 0; mi < kWMT; ++mi) {
          const int mt = wm * mtw + mi;
          if (mi < mtw && mt < mt_n) {
            const int q = lane >> 3, i = lane & 7;
            ldsm_x4_t(af[mi], M + (ks * 16 + i + (q >> 1) * 8) * d.wldm + mt * 16 + (q & 1) * 8);
          }
        }
        // this lane's B rows: ks*16 + 2 t4 (+1) in b0, + 8 (+1) in b1
        float at[G][4];
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const int rr = ks * 16 + t4 * 2;
          at[gi][0] = at_b[rr * G + gi];
          at[gi][1] = at_b[(rr + 1) * G + gi];
          at[gi][2] = at_b[(rr + 8) * G + gi];
          at[gi][3] = at_b[(rr + 9) * G + gi];
        }
#pragma unroll
        for (int ni = 0; ni < kWNT; ++ni) {
          const int nt = wn * ntw + ni;
          if (ni < ntw && nt < nt_n) {
            uint32_t b0, b1;
            ldsm_x2_t(b0, b1, Z + (ks * 16 + (lane & 15)) * d.ldz + nt * 8);
            if constexpr (kRegScale) {
#pragma unroll
              for (int gi = 0; gi < G; ++gi) {
                if (gi < ng) {
                  const uint32_t s0 = scale_pair(b0, at[gi][0], at[gi][1]);
                  const uint32_t s1 = scale_pair(b1, at[gi][2], at[gi][3]);
#pragma unroll
                  for (int mi = 0; mi < kWMT; ++mi)
                    if (mi < mtw && wm * mtw + mi < mt_n) mma_bf16_16816(acc[gi][mi][ni], af[mi], s0, s1);
                }
              }
            } else {
#pragma unroll
              for (int mi = 0; mi < kWMT; ++mi)
                if (mi < mtw && wm * mtw + mi < mt_n) mma_bf16_16816(acc[0][mi][ni], af[mi], b0, b1);
              if constexpr (kSplit) {
                ldsm_x2_t(b0, b1, Zlo + (ks * 16 + (lane & 15)) * d.ldz + nt * 8);
#pragma unroll
                for (int mi = 0; mi < kWMT; ++mi)
                  if (mi < mtw && wm * mtw + mi < mt_n) mma_bf16_16816(acc[0][mi][ni], af[mi], b0, b1);
              }
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int it = 0; it < kItW; ++it) {
        const int item = threadIdx.x + it * blockDim.x;
        if (item < items) {
          const int m0 = (item / nq_n) * kRT, n0 = (item % nq_n) * kCT;
          for (int r = 0; r < kChunk; ++r) {
            float x[kRT], z[kCT];
#pragma unroll
            for (int i = 0; i < kRT; ++i) x[i] = to_f(M[r * d.wldm + m0 + i]);
#pragma unroll
            for (int j = 0; j < kCT; ++j) z[j] = to_f(Z[r * d.ldz + n0 + j]);
#pragma unroll
            for (int i = 0; i < kRT; ++i)
#pragma unroll
              for (int j = 0; j < kCT; ++j) acc[0][it][i][j] = fmaf(x[i], z[j], acc[0][it][i][j]);
          }
        }
      }
    }
    WG_CLOCK(1);  // multiplying (thread 0's warp)
    if (more && threadIdx.x < kChunk * G) att[bn * kChunk * G + threadIdx.x] = att_next;
    __syncthreads();  // every thread is done with buffer b before it refills
    WG_CLOCK(2);      // the other warps' multiplies
  }
  // ---- this range's tiles of dW_layer[c] (rows c*C1 + m of W' [A*C1, D])
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi >= ng) continue;
    float* out = partials + sp * d.nw + gmma::layer_field(layers, layer, gmma::kWOff) +
                 (long)(c0 + gi) * c1 * dd + (long)mw0 * dd + nw0;  // the window's corner
    if constexpr (MMA) {
#pragma unroll
      for (int mi = 0; mi < kWMT; ++mi) {
        const int mt = wm * mtw + mi;
#pragma unroll
        for (int ni = 0; ni < kWNT; ++ni) {
          const int nt = wn * ntw + ni;
          if (mi < mtw && mt < mt_n && ni < ntw && nt < nt_n) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int m = mt * 16 + g + (q >> 1) * 8, n = nt * 8 + t4 * 2 + (q & 1);
              if (m < c1w && n < ddw) out[(long)m * dd + n] = TILES ? rnd<T>(acc[gi][mi][ni][q])
                                                                     : acc[gi][mi][ni][q];
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int it = 0; it < kItW; ++it) {
        const int item = threadIdx.x + it * blockDim.x;
        if (item < items) {
          const int m0 = (item / nq_n) * kRT, n0 = (item % nq_n) * kCT;
#pragma unroll
          for (int i = 0; i < kRT; ++i)
#pragma unroll
            for (int j = 0; j < kCT; ++j)
              if (m0 + i < c1w && n0 + j < ddw)
                out[(long)(m0 + i) * dd + n0 + j] = TILES ? rnd<T>(acc[gi][it][i][j])
                                                          : acc[gi][it][i][j];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. The table sum: per gather tile, d_hu[u] = sum of the d_hs rows of the
// tile's slots with loc == u, in slot order (fp32, rounded once).
template <typename T>
__global__ void __launch_bounds__(kThreads)
table_kernel(const T* __restrict__ dhs, const int* __restrict__ loc, T* __restrict__ dhu, int f,
             int k, int tile, int u) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* start = reinterpret_cast<int*>(smem_raw);  // [u + 1]
  int* cur = start + u + 1;                        // [u]
  int* perm = cur + u;                             // [tile * k]
  const int tl = blockIdx.x;
  const int slots = tile * k;
  const int* tloc = loc + (long)tl * slots;
  const T* tdhs = dhs + (long)tl * slots * f;
  for (int i = threadIdx.x; i < u; i += blockDim.x) cur[i] = 0;
  __syncthreads();
  for (int sl = threadIdx.x; sl < slots; sl += blockDim.x) {
    const int l = tloc[sl];
    if (l >= 0 && l < u) atomicAdd(&cur[l], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int i = 0; i < u; ++i) {
      start[i] = run;
      run += cur[i];
      cur[i] = 0;
    }
    start[u] = run;
  }
  __syncthreads();
  for (int sl = threadIdx.x; sl < slots; sl += blockDim.x) {
    const int l = tloc[sl];
    if (l >= 0 && l < u) perm[start[l] + atomicAdd(&cur[l], 1)] = sl;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < u; i += blockDim.x) {  // each bucket in slot order
    for (int q = start[i] + 1; q < start[i + 1]; ++q) {
      const int x = perm[q];
      int z = q - 1;
      while (z >= start[i] && perm[z] > x) {
        perm[z + 1] = perm[z];
        --z;
      }
      perm[z + 1] = x;
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < u * f; w += blockDim.x) {
    const int i = w / f, col = w % f;
    float acc = 0.f;
    for (int q = start[i]; q < start[i + 1]; ++q) acc += to_f(tdhs[(long)perm[q] * f + col]);
    dhu[((long)tl * u + i) * f + col] = from_f<T>(acc);
  }
}

// ---------------------------------------------------------------------------
// Host side.

// fp32: the chain's weight slice in shared memory where it fits beside the
// rows, else read from global memory; then the rows halved (down to K) until
// the block fits.  Past that the block needs more than the card has, and the
// wrapper raises.
Dims fit_fma(Dims d) {
  if (chain_smem<float>(d) > gmma::kMaxSmem) d.nbuf = 0;
  while (chain_smem<float>(d) > gmma::kMaxSmem && d.rows / 2 >= d.k) {
    d.rows /= 2;
    d.rb = d.rows / d.k;
  }
  return d;
}

Dims dims_for(int dtype, int n, int f, int k, int a, int tile, int u, int nl, const int* w3) {
  const Dims d = make_dims(dtype == 1, n, f, k, a, tile, u, nl, w3);
  return dtype == 1 ? d : fit_fma(d);
}

// -1 for shapes the kernels do not take, else the chain's and the weight-
// gradient kernel's shared memory, the larger (more than the card has for
// widths past what fits)
long smem_for(int dtype, int k, int a, int nl, const int* w3) {
  if (k < 1 || a < 1 || nl < 1 || w3 == nullptr) return -1;
  for (int l = 0; l < nl; ++l) {
    const int c1 = w3[3 * l], dd = w3[3 * l + 1];
    if (c1 < 1 || dd < 1) return -1;
  }
  if (dtype != 0 && dtype != 1) return -1;
  const Dims d = dims_for(dtype, 1, 0, k, a, 1, 1, nl, w3);
  if (d.rb < 1) return -1;
  const long cs = dtype == 1 ? chain_smem<bf16>(d) : chain_smem<float>(d);
  const long ws = dtype == 1 ? (wgrad_smem<bf16>(d, 2, true) > wgrad_smem<bf16>(d, kWgradBufs, false)
                                    ? wgrad_smem<bf16>(d, 2, true)
                                    : wgrad_smem<bf16>(d, kWgradBufs, false))
                             : wgrad_smem<float>(d, 2, true);
  return cs > ws ? cs : ws;
}

// the layers' widths chain (C1_0 = 2F+1, C1_l+1 = dk_l <= D_l)
bool widths_ok(int f, int nl, const int* w3) {
  if (w3[0] != 2 * f + 1) return false;
  for (int l = 0; l < nl; ++l) {
    if (w3[3 * l + 2] < 1 || w3[3 * l + 2] > w3[3 * l + 1]) return false;
    if (l + 1 < nl && w3[3 * (l + 1)] != w3[3 * l + 2]) return false;
  }
  return true;
}

template <typename K>
cudaError_t set_smem(K kern, long smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// the chain's bf16 weight streams (kernels/tile_plan.py): wpk the packed
// tiles, masks the plan's bit masks, chunks the streams' first chunks then
// the chunk table, the streams and chunks in the order the chain takes them
struct Packed {
  const void* wpk;
  const void* masks;
  const void* chunks;
  int nstreams, nq;
};

// the chain's arguments (null where a mode or an addressing takes none)
struct ChainArgs {
  const void *hs, *h, *geo2, *loc, *gtab, *w, *sel, *layers, *yin, *dagg;
  void *dhs, *dhr, *dy, *m0, *m;
};

template <typename T, bool MMA, Mode MODE, bool TAB>
int launch_chain(const Dims& d, const ChainArgs& c, const Packed& pk, cudaStream_t st) {
  const long smem = chain_smem<T>(d);
  auto kern = chain_kernel<T, MMA, MODE, TAB>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (d.n + d.rb - 1) / d.rb;
  if (grid < 1) return 0;
  kern<<<grid, MMA ? kThreadsChainMma : kThreads, smem, st>>>(
      static_cast<const T*>(c.hs), static_cast<const T*>(c.h), static_cast<const T*>(c.geo2),
      static_cast<const int*>(c.loc), static_cast<const int*>(c.gtab),
      static_cast<const T*>(c.w), static_cast<const int*>(c.sel),
      static_cast<const int*>(c.layers), static_cast<const T*>(c.yin),
      static_cast<const T*>(c.dagg), static_cast<T*>(c.dhs), static_cast<T*>(c.dhr),
      static_cast<T*>(c.dy), static_cast<T*>(c.m0), static_cast<T*>(c.m),
      static_cast<const bf16*>(pk.wpk), static_cast<const uint32_t*>(pk.masks),
      static_cast<const int*>(pk.chunks), pk.nstreams, pk.nq, d);
  return (int)cudaGetLastError();
}

// bf16: the forward streams of every layer (replay modes), then every
// layer's dm stream; fp32: the flat weights.  (A chunk holds at least one
// row: no more chunks than masks.)
bool packed_ok(int dtype, const Packed& pk, const Dims& d, bool replays, const void* w) {
  if (dtype != 1) return w != nullptr;
  return pk.wpk != nullptr && pk.masks != nullptr && pk.chunks != nullptr &&
         pk.nstreams == (replays ? 2 : 1) * d.nl && pk.nq >= 0 && pk.nq <= d.nmasks;
}

// the chain's checks shared by both addressings
bool chain_ok(int dtype, const Dims& d, const ChainArgs& c, const Packed& pk, bool replays) {
  return c.sel != nullptr && c.layers != nullptr && c.dagg != nullptr && c.dy != nullptr &&
         (replays || c.yin != nullptr) && (d.nl == 1 || c.m != nullptr) &&
         packed_ok(dtype, pk, d, replays, c.w);
}

// in: geo2, m0, m (layers 1..), dy, hs, h, layers (hs non-null: m_0 rebuilt from hs, h)
template <typename T, bool MMA, bool TILES, int G, bool REBUILD>
int launch_wgrad_as(const Dims& d, const void* const* in, float* partials, cudaStream_t st) {
  const long smem = wgrad_smem<T>(d, MMA && !TILES ? kWgradBufs : 2, TILES);
  auto kern = wgrad_kernel<T, MMA, TILES, G, REBUILD>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  if ((long)d.n * d.k < 1 || d.splits < 1) return 0;
  kern<<<dim3((d.a + G - 1) / G * d.nwin, d.splits, d.nl), kThreads, smem, st>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]), static_cast<const T*>(in[2]),
      static_cast<const T*>(in[3]), static_cast<const T*>(in[4]), static_cast<const T*>(in[5]),
      static_cast<const int*>(in[6]), partials, d);
  return (int)cudaGetLastError();
}

template <typename T, bool MMA, bool TILES, int G>
int launch_wgrad(const Dims& d, const void* const* in, float* partials, cudaStream_t st) {
  return in[4] != nullptr ? launch_wgrad_as<T, MMA, TILES, G, true>(d, in, partials, st)
                          : launch_wgrad_as<T, MMA, TILES, G, false>(d, in, partials, st);
}

template <typename T>
int launch_table(const void* dhs, const int* loc, void* dhu, int n, int f, int k, int tile,
                 int u, cudaStream_t st) {
  const long smem = 4L * (2L * u + 1 + (long)tile * k);
  auto kern = table_kernel<T>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = n / tile;
  if (grid < 1) return 0;
  kern<<<grid, kThreads, smem, st>>>(static_cast<const T*>(dhs), loc, static_cast<T*>(dhu), f,
                                     k, tile, u);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The shared memory one block may take (bytes): the limit the fp32 chain's
// dims fit into and the wrapper checks smem_bytes against.
long fused_message_generic_tab_bwd_max_smem() { return gmma::kMaxSmem; }

// Shared memory one block of the chain or weight-gradient kernel needs
// (bytes, the larger), or -1 for shapes the kernels do not take; widths: the
// nl layers' (C1, D, dk) in host memory.  The wrapper checks it against
// max_smem (past it the widths do not fit a block).
long fused_message_generic_tab_bwd_smem_bytes(int dtype, int k, int a, int nl,
                                              const int* widths) {
  return smem_for(dtype, k, a, nl, widths);
}

// The chain: kernel #10 (replay = 1: y recomputed) or #9 (replay = 0: yin the
// saved ys, [N*K, D_l] per layer one after the other).  dtype: 0 = float32
// (FMA engine, w the layers' flat weights [A*C1][D]), 1 = bfloat16 (the
// engine of generic_mma.cuh: wpk the listed 16x8 tiles of the streams the
// chain takes, every layer's forward tiles first to last in replay mode, then
// every layer's dm tiles last to first, in nq chunks; chunks the streams'
// first chunks then every chunk's first tile; masks the plan's bit masks; w
// unused).  sel: the layers' selections one after the other; layers: the
// layer table (device memory, generic_mma.cuh LayerField); widths: the
// layers' (C1, D, dk) (host memory).  Outputs d_hs [N*K, F], d_hr [N, F],
// dy (every layer's [N*K, D rounded up to 8], one after the other) and, for
// the weight-gradient kernel, m0 [N*K, C1_0 rounded up to 16] and m (m_1 ..
// m_L-1 likewise; null at one layer), zero-padded.  Returns
// cudaGetLastError() after the launch.
int fused_message_generic_tab_bwd_chain(int dtype, int replay, const void* h, const void* geo2,
                                        const void* loc, const void* gtab, const void* w,
                                        const void* sel, const void* layers, const void* yin,
                                        const void* dagg, void* dhs, void* dhr, void* dy,
                                        void* m0, void* m, const void* wpk, const void* masks,
                                        const void* chunks, int n, int f, int k, int a, int tile,
                                        int u, int nl, const int* widths, int nq, void* stream) {
  if (smem_for(dtype, k, a, nl, widths) < 0 || !widths_ok(f, nl, widths))
    return (int)cudaErrorInvalidValue;
  const Packed pk{wpk, masks, chunks, (replay ? 2 : 1) * nl, nq};
  const ChainArgs c{h, h, geo2, loc, gtab, w, sel, layers, yin, dagg, dhs, dhr, dy, m0, m};
  const Dims d = dims_for(dtype, n, f, k, a, tile, u, nl, widths);
  if (!chain_ok(dtype, d, c, pk, replay != 0) || m0 == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return replay ? launch_chain<float, false, Mode::kReplay, true>(d, c, pk, st)
                  : launch_chain<float, false, Mode::kResidual, true>(d, c, pk, st);
  return replay ? launch_chain<bf16, true, Mode::kReplay, true>(d, c, pk, st)
                : launch_chain<bf16, true, Mode::kResidual, true>(d, c, pk, st);
}

// The untabled chain: kernel #12 (mode = 0, yin the saved ys), #13 (mode = 1,
// replay) or #14's chain (mode = 2, replay with JAX's AD rounding of the dm
// GEMMs; its dm streams hold the components last first).  hs [K, N, F]
// slot-major sender rows, h [N, F] the receivers; d_hs comes out [K, N, F],
// the other outputs as above; m0 may be null (the weight gradients rebuild
// it).
int fused_message_generic_bwd_chain(int dtype, int mode, const void* hs, const void* h,
                                    const void* geo2, const void* w, const void* sel,
                                    const void* layers, const void* yin, const void* dagg,
                                    void* dhs, void* dhr, void* dy, void* m0, void* m,
                                    const void* wpk, const void* masks, const void* chunks,
                                    int n, int f, int k, int a, int nl, const int* widths, int nq,
                                    void* stream) {
  if (smem_for(dtype, k, a, nl, widths) < 0 || !widths_ok(f, nl, widths))
    return (int)cudaErrorInvalidValue;
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  if ((long)k * n > 2147483647L) return (int)cudaErrorInvalidValue;
  const Packed pk{wpk, masks, chunks, (mode != 0 ? 2 : 1) * nl, nq};
  const ChainArgs c{hs, h, geo2, nullptr, nullptr, w, sel, layers, yin, dagg, dhs, dhr, dy, m0, m};
  const Dims d = dims_for(dtype, n, f, k, a, 1, 0, nl, widths);
  if (!chain_ok(dtype, d, c, pk, mode != 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mode ? launch_chain<float, false, Mode::kReplay, false>(d, c, pk, st)
                : launch_chain<float, false, Mode::kResidual, false>(d, c, pk, st);
  if (mode == 2) return launch_chain<bf16, true, Mode::kVjp, false>(d, c, pk, st);
  return mode ? launch_chain<bf16, true, Mode::kReplay, false>(d, c, pk, st)
              : launch_chain<bf16, true, Mode::kResidual, false>(d, c, pk, st);
}

// The weight gradients: partials [splits, NW] fp32, NW = A sum_l C1_l D_l,
// each row the sum over one range of slot rows (W' layouts [A*C1, D] one
// after the other), from the chain's m (layers 1..) and dy, the attributes in
// geo2 and m0: the chain's rows, or (hs non-null, untabled) rebuilt from hs
// [K, N, F] and h [N, F].  group: the components per block, the kernel's
// (bf16 2, fp32 1).
int fused_message_generic_tab_bwd_wgrad(int dtype, const void* geo2, const void* m0,
                                        const void* m, const void* dy, const void* hs,
                                        const void* h, const void* layers, void* partials, int n,
                                        int f, int k, int a, int nl, const int* widths,
                                        int splits, int group, void* stream) {
  if (smem_for(dtype, k, a, nl, widths) < 0 || splits < 1) return (int)cudaErrorInvalidValue;
  if (group != (dtype == 1 ? kGroup : 1) || !widths_ok(f, nl, widths))
    return (int)cudaErrorInvalidValue;
  if (hs == nullptr ? m0 == nullptr : h == nullptr) return (int)cudaErrorInvalidValue;
  if (layers == nullptr || dy == nullptr || (nl > 1 && m == nullptr))
    return (int)cudaErrorInvalidValue;
  Dims d = make_dims(dtype == 1, n, f, k, a, 1, 1, nl, widths);
  d.splits = splits;
  const void* in[7] = {geo2, m0, m, dy, hs, h, layers};
  float* part = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_wgrad<float, false, false, 1>(d, in, part, st);
  return launch_wgrad<bf16, true, false, kGroup>(d, in, part, st);
}

// Kernel #14's weight gradients: partials [ntiles, NW] fp32, row t the sum over
// the slot rows of backward tile tile0 + t (tile_rows of them; the last tile
// may be short) of m_l^T (dy_l attr_c), dya in fp32, rounded to the data type;
// layouts as above (m0 from the chain).
int fused_message_generic_bwd_wgrad_tiles(int dtype, const void* geo2, const void* m0,
                                          const void* m, const void* dy, const void* layers,
                                          void* partials, int n, int k, int a, int nl,
                                          const int* widths, int tile_rows, int tile0,
                                          int ntiles, void* stream) {
  if (smem_for(dtype, k, a, nl, widths) < 0 || tile_rows < 1 || tile0 < 0 || ntiles < 0)
    return (int)cudaErrorInvalidValue;
  if ((long)(tile0 + ntiles - 1) * tile_rows >= (long)n * k && ntiles > 0)
    return (int)cudaErrorInvalidValue;
  if (m0 == nullptr || layers == nullptr || dy == nullptr || (nl > 1 && m == nullptr))
    return (int)cudaErrorInvalidValue;
  Dims d = make_dims(dtype == 1, n, 0, k, a, 1, 1, nl, widths);
  d.splits = ntiles;
  d.trows = tile_rows;
  d.tile0 = tile0;
  const void* in[7] = {geo2, m0, m, dy, nullptr, nullptr, layers};
  float* part = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_wgrad_as<float, false, true, 1, false>(d, in, part, st);
  return launch_wgrad_as<bf16, true, true, 1, false>(d, in, part, st);
}

// The table sum: d_hu [N/tile * U, F] from d_hs [N*K, F] and loc [N, K].
int fused_message_generic_tab_bwd_table(int dtype, const void* dhs, const void* loc, void* dhu,
                                        int n, int f, int k, int tile, int u, void* stream) {
  if (tile < 1 || n % tile != 0 || u < 1) return (int)cudaErrorInvalidValue;
  const int* loc_i = static_cast<const int*>(loc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_table<float>(dhs, loc_i, dhu, n, f, k, tile, u, st);
  if (dtype == 1) return launch_table<bf16>(dhs, loc_i, dhu, n, f, k, tile, u, st);
  return (int)cudaErrorInvalidValue;
}

#ifdef GENERIC_WGRAD_CLOCKS
// the weight-gradient blocks' cycles (wait, own multiply, barrier), summed
// over every block since the last call (then 0)
int generic_wgrad_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, wgrad_cycles, sizeof(wgrad_cycles));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[4] = {0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(wgrad_cycles, zero, sizeof(zero));
}
#endif

}  // extern "C"
