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
// d_agg [N, dk2] of
//
//   m0 = [x_s || h[i] || d2],  y_l = sum_c (m_l W_l[c]) attr_c,
//   m_l+1 = y_l[:, :dk_l] * sigmoid(y_l)[:, sel_l],   agg[i] = sum_k mask * m_2,
//
// (x_s = h[gtab[i / tile, loc[i,k]]] tabled, hs[k, i] untabled) per slot and
// layer, last to first: dy = VJP of the gate at y; dya_c = dy attr_c;
// dW_l[c] += m_l^T dya_c; dm_l-1 = sum_c dya_c W_l[c]^T.  Outputs: the sender
// cotangents (tabled: d_hu [ntiles*U, F], summed per table entry; untabled:
// d_hs [K, N, F], one row per slot, slot-major as the TPU kernel writes it),
// d_hr [N, F] (receiver cotangents summed over the K slots) and the fp32
// weight gradients.
//
// Rounding points (the TPU kernel's): dm_2 = d_agg * mask rounded to the data
// type; the gate VJP as JAX's AD computes it (dout * multiplier and dout * y
// rounded; the selection transpose summed in fp32 and rounded; the sigmoid's
// VJP g * (s * (1 - s)) in fp32 and rounded; the two branches added and
// rounded); dya_c = dy * attr_c rounded; the products in fp32; dm rounded; the
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
//    (128 slot rows in bf16, 64 in fp32), as kernel #8 does, and runs the
//    chain for its rows: in replay mode the two forward GEMMs of #8 (the same
//    arithmetic, so both modes give bitwise the same y), in residual mode a
//    load of the saved y; then per layer the gate VJP (a warp per row, in
//    place over y) and the dm GEMM.  The weights stream one attribute
//    component at a time through shared memory (cp.async, double buffer, the
//    [A][D16][C16] layout of #8); the dm GEMM reads W_c^T out of the same
//    slice by ldmatrix.trans.  It writes, per slot row, each layer's input m
//    and dy (for the weight gradients), the rounded sender cotangent d_hs
//    (tabled: [N*K, F] node-major, for the table sum; untabled: [K, N, F],
//    the kernel's output), and per receiver d_hr.
// 2. wgrad.  dW_l[c] = m_l^T (dy_l attr_c) sums over all N*K slot rows: 1.05
//    MB of fp32 at the lmax=2 config, far more than a block's shared memory,
//    and CUDA blocks run in no order, so there is no carried sum as on the
//    TPU.  Each block owns one (layer, component, row range) output tile
//    [C1, D] in registers and streams its rows' m and dy in chunks of 64 by
//    cp.async into a double buffer (chunk i+1 loads while chunk i
//    multiplies), scales dy by attr_c in shared memory and multiplies on the
//    tensor cores (both operands by ldmatrix.trans); it writes its tile into
//    a per-range partial [splits, NW].  Rebuilding m here instead (the
//    gathers and the gate, once per component) took most of the kernel's
//    time on an H100, hence the rows from the chain.  No float atomics; the
//    partials are summed in range order by the fixed-order reduction of
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
// bf16 runs the GEMMs on mma.sync m16n8k16 (fp32 accumulate); fp32 (the
// check path) on the FMA units.  Widths are runtime arguments up to C1 <= 192
// and D <= 128; the chain keeps the geometry in the data type in shared
// memory, so A = 36 (lmax_attr = 5, 38 values per slot) fits a block at the
// lmax=2 widths (227,600 of the 232,448 bytes a block may use, in bf16).
//
// Work and bound.  Per valid slot the function needs 2 x the folded nonzeros
// for the dW and the dm products (#9: 120,960 flops at the lmax=2 config) and
// once more for the replay (#10, #13, #14: 181,440); the kernels run the
// dense folded GEMMs (2 and 3 x 526,824 per slot; #14's weight gradients
// twice, dya = hi + lo).  #9 also reads the saved ys (1.7 GB at
// 250k points in bf16), so it is bound by bytes; #10 by operations.  This
// first version is simple: one block per SM, mma.sync, dense folded GEMMs,
// the m and dy rows through device memory and read once per component;
// wgmma/TMA, block-sparse W' and fewer passes over the rows are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsMma = 128;  // chain, bf16: 8 warps x 16 rows
constexpr int kRowsFma = 64;   // chain, fp32
constexpr int kMaxC1 = 192;    // widths taken: C1 <= 192, D <= 128
constexpr int kMaxD = 128;
constexpr int kMaxKS = kMaxC1 / 16;  // replay GEMM: k-steps over C1
constexpr int kMaxNT = kMaxD / 8;    // replay GEMM: n-tiles over D
constexpr int kMaxDS = kMaxD / 16;   // dm GEMM: k-steps over D
constexpr int kMaxCT = kMaxC1 / 8;   // dm GEMM: n-tiles over C1
constexpr int kMaxLanes = kMaxD / 32;  // gate VJP: columns per lane
constexpr int kRT = 4, kCT = 4;        // FMA engine: rows x columns per work item
constexpr int kItChain = 3;            // FMA chain: work items per thread
constexpr int kItW = 6;                // FMA wgrad: work items per thread
constexpr int kChunk = 64;             // wgrad: slot rows per chunk
constexpr int kWMT = 3, kWNT = 8;      // wgrad mma: m-tiles x n-tiles per warp

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two 8x8 b16 matrices, transposed: rows from lanes 0-7 and 8-15
__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(s));
}
// four 8x8 b16 matrices, transposed: rows from lanes 0-7, 8-15, 16-23, 24-31
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// two bf16 at p scaled by s, each product rounded to bf16, packed (low = p[0])
__device__ __forceinline__ uint32_t scale2(const bf16* p, float s) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  __nv_bfloat162 o = __floats2bfloat162_rn(__fmul_rn(v.x, s), __fmul_rn(v.y, s));
  return *reinterpret_cast<uint32_t*>(&o);
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline long align16(long bytes) { return (bytes + 15) / 16 * 16; }

struct Dims {
  int n, f, k, a, tile, u;
  int c1a, da, dk1, c1b, db, dk2;
  int rows, rb;    // chain: slot rows per block, receivers per block
  int ldm;         // m / dm row stride (elements)
  int ldy;         // y / dy row stride (elements)
  int ldw, wbuf;   // weight-slice row stride, elements per weight buffer
  int nbuf;        // weight buffers (2: double buffer, mma; 1: fma)
  int gs;          // geometry per slot: a + 2
  int ldg1, ldg2;  // dy rows in global memory (D rounded up to 8)
  int kp0, kp1;    // m_0 / m_1 rows in global memory (C1 rounded up to 16)
  int splits;      // wgrad: row ranges
  int ldz;         // wgrad: dya row stride
  int trows, tile0;  // wgrad, per tile (#14): slot rows per tile, the first tile
};

__host__ __device__ inline Dims make_dims(bool mma, int n, int f, int k, int a, int tile, int u,
                                          int c1a, int da, int dk1, int c1b, int db, int dk2) {
  Dims d;
  d.n = n; d.f = f; d.k = k; d.a = a; d.tile = tile; d.u = u;
  d.c1a = c1a; d.da = da; d.dk1 = dk1; d.c1b = c1b; d.db = db; d.dk2 = dk2;
  const int c1max = c1a > c1b ? c1a : c1b;
  const int dmax = da > db ? da : db;
  d.rows = mma ? kRowsMma : kRowsFma;
  d.rb = k > 0 ? d.rows / k : 0;
  // row strides: 16-byte rows whose 16-byte count is odd (conflict-free
  // fragment loads and ldmatrix)
  d.ldm = round_up(c1max, 16) + 8;
  d.ldy = round_up(dmax, 16) + 8;
  d.ldz = d.ldy;
  if (mma) {
    d.ldw = d.ldm;                     // slices [D16][ldw], C1 contiguous
    d.wbuf = round_up(dmax, 16) * d.ldw;
    d.nbuf = 2;
  } else {
    d.ldw = round_up(dmax, 4);         // slices [C1][ldw], D contiguous
    d.wbuf = c1max * d.ldw;
    d.nbuf = 1;
  }
  d.gs = a + 2;
  d.ldg1 = round_up(da, 8);
  d.ldg2 = round_up(db, 8);
  d.kp0 = round_up(c1a, 16);
  d.kp1 = round_up(c1b, 16);
  d.splits = 1;
  d.trows = 0;
  d.tile0 = 0;
  return d;
}

// chain shared memory: geometry, ints (senders, receivers, selections and
// their inverse tables), the per-warp gate scratch, m, y_1, y_2, weights
__host__ __device__ inline long chain_ints(const Dims& d) {
  return 2L * d.rows + 2L * d.dk1 + 2L * d.dk2 + d.da + d.db + 2;
}
template <typename T>
__host__ __device__ inline long chain_smem(const Dims& d) {
  return align16((long)sizeof(T) * d.rows * d.gs) + align16(4L * chain_ints(d)) +
         align16(4L * kWarps * kMaxD) + align16((long)sizeof(T) * d.rows * d.ldm) +
         2 * align16((long)sizeof(T) * d.rows * d.ldy) +
         align16((long)sizeof(T) * d.nbuf * d.wbuf);
}
// (per tile, #14: one more dya buffer, the low halves of dya in bf16)
template <typename T>
__host__ __device__ inline long wgrad_smem(const Dims& d, bool tiles) {
  return 2 * align16((long)sizeof(T) * kChunk * d.ldm) +
         (tiles ? 3 : 2) * align16((long)sizeof(T) * kChunk * d.ldz) + 8L * kChunk;
}

// ---------------------------------------------------------------------------
// GEMM engines.  Each starts with a block barrier (its inputs complete, the
// weight buffers free) and leaves its output in shared memory.

// Copy attribute component c's weight slice [dpl][kp] (global, contiguous)
// into dst [dpl][ldw] by cp.async, then commit the group.
__device__ __forceinline__ void load_slice(const bf16* __restrict__ Wk, int c, int dpl, int kp,
                                           int ldw, bf16* dst) {
  const bf16* src = Wk + (long)c * dpl * kp;
  const int row_chunks = kp / 8;  // 16-byte pieces per row
  for (int i = threadIdx.x; i < dpl * row_chunks; i += blockDim.x) {
    const int nn = i / row_chunks, ch = i % row_chunks;
    cp_async16(dst + nn * ldw + ch * 8, src + (long)nn * kp + ch * 8);
  }
  cp_async_commit();
}

// y = sum_c attr_c * (M @ W[c]) on the tensor cores, rounded to bf16 into Y
// (columns up to D rounded to 16; the pad is zero).  The arithmetic of kernel
// #8's layer_mma, so the replay gives bitwise the forward's y.
__device__ void layer_fwd_mma(const bf16* __restrict__ Wk, int c1, int dd, const Dims& d,
                              const bf16* M, bf16* Wt, bf16* Y, const bf16* geo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const int kp = round_up(c1, 16), dpl = round_up(dd, 16);
  const int ks_n = kp / 16, nt_n = dpl / 8;
  __syncthreads();
  load_slice(Wk, 0, dpl, kp, d.ldw, Wt);
  float acc[kMaxNT][4];
#pragma unroll
  for (int nt = 0; nt < kMaxNT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const bf16* a0 = M + (r0 + g) * d.ldm + t4 * 2;
  const bf16* a1 = a0 + 8 * d.ldm;
  for (int c = 0; c < d.a; ++c) {
    const bf16* cur = Wt + (c & 1) * d.wbuf;
    if (c + 1 < d.a) {
      load_slice(Wk, c + 1, dpl, kp, d.ldw, Wt + ((c + 1) & 1) * d.wbuf);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice c has landed for every thread
    float t[kMaxNT][4];
#pragma unroll
    for (int nt = 0; nt < kMaxNT; ++nt) t[nt][0] = t[nt][1] = t[nt][2] = t[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kMaxKS; ++ks) {
      if (ks < ks_n) {
        uint32_t af[4];
        af[0] = *reinterpret_cast<const uint32_t*>(a0 + ks * 16);
        af[1] = *reinterpret_cast<const uint32_t*>(a1 + ks * 16);
        af[2] = *reinterpret_cast<const uint32_t*>(a0 + ks * 16 + 8);
        af[3] = *reinterpret_cast<const uint32_t*>(a1 + ks * 16 + 8);
        const bf16* wb = cur + g * d.ldw + ks * 16 + t4 * 2;
#pragma unroll
        for (int nt = 0; nt < kMaxNT; ++nt) {
          if (nt < nt_n) {
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wb + nt * 8 * d.ldw);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wb + nt * 8 * d.ldw + 8);
            mma_bf16_16816(t[nt], af, b0, b1);
          }
        }
      }
    }
    const float at0 = to_f(geo[(r0 + g) * d.gs + c]), at1 = to_f(geo[(r0 + g + 8) * d.gs + c]);
#pragma unroll
    for (int nt = 0; nt < kMaxNT; ++nt) {
      acc[nt][0] = __fadd_rn(acc[nt][0], __fmul_rn(at0, t[nt][0]));
      acc[nt][1] = __fadd_rn(acc[nt][1], __fmul_rn(at0, t[nt][1]));
      acc[nt][2] = __fadd_rn(acc[nt][2], __fmul_rn(at1, t[nt][2]));
      acc[nt][3] = __fadd_rn(acc[nt][3], __fmul_rn(at1, t[nt][3]));
    }
    __syncthreads();  // every warp is done with slice c before its buffer refills
  }
#pragma unroll
  for (int nt = 0; nt < kMaxNT; ++nt) {
    if (nt < nt_n) {
      const int col = nt * 8 + t4 * 2;
      *reinterpret_cast<__nv_bfloat162*>(Y + (r0 + g) * d.ldy + col) =
          __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(Y + (r0 + g + 8) * d.ldy + col) =
          __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
    }
  }
}

// dm = sum_c (dy * attr_c, rounded to bf16) @ W[c]^T on the tensor cores,
// rounded to bf16 into Out (columns up to C1 rounded to 8).  W[c]^T comes out
// of the same [D16][C16] slices by ldmatrix.trans.
__device__ void layer_bwd_mma(const bf16* __restrict__ Wk, int c1, int dd, const Dims& d,
                              const bf16* DY, bf16* Wt, bf16* Out, const bf16* geo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const int kp = round_up(c1, 16), dpl = round_up(dd, 16);
  const int ds_n = dpl / 16, ct_n = (c1 + 7) / 8;
  __syncthreads();
  load_slice(Wk, 0, dpl, kp, d.ldw, Wt);
  float acc[kMaxCT][4];
#pragma unroll
  for (int ct = 0; ct < kMaxCT; ++ct) acc[ct][0] = acc[ct][1] = acc[ct][2] = acc[ct][3] = 0.f;
  const bf16* a0 = DY + (r0 + g) * d.ldy + t4 * 2;
  const bf16* a1 = a0 + 8 * d.ldy;
  for (int c = 0; c < d.a; ++c) {
    const bf16* cur = Wt + (c & 1) * d.wbuf;
    if (c + 1 < d.a) {
      load_slice(Wk, c + 1, dpl, kp, d.ldw, Wt + ((c + 1) & 1) * d.wbuf);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float at0 = to_f(geo[(r0 + g) * d.gs + c]), at1 = to_f(geo[(r0 + g + 8) * d.gs + c]);
#pragma unroll
    for (int ds = 0; ds < kMaxDS; ++ds) {
      if (ds < ds_n) {
        uint32_t af[4];
        af[0] = scale2(a0 + ds * 16, at0);
        af[1] = scale2(a1 + ds * 16, at1);
        af[2] = scale2(a0 + ds * 16 + 8, at0);
        af[3] = scale2(a1 + ds * 16 + 8, at1);
        const bf16* wrow = cur + (ds * 16 + (lane & 15)) * d.ldw;
#pragma unroll
        for (int ct = 0; ct < kMaxCT; ++ct) {
          if (ct < ct_n) {
            uint32_t b0, b1;
            ldsm_x2_t(b0, b1, wrow + ct * 8);
            mma_bf16_16816(acc[ct], af, b0, b1);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int ct = 0; ct < kMaxCT; ++ct) {
    if (ct < ct_n) {
      const int col = ct * 8 + t4 * 2;
      *reinterpret_cast<__nv_bfloat162*>(Out + (r0 + g) * d.ldm + col) =
          __floats2bfloat162_rn(acc[ct][0], acc[ct][1]);
      *reinterpret_cast<__nv_bfloat162*>(Out + (r0 + g + 8) * d.ldm + col) =
          __floats2bfloat162_rn(acc[ct][2], acc[ct][3]);
    }
  }
}

// Kernel #14's dm (JAX's AD of _layer_tp in bf16): per component dya_c = dy *
// attr_c in fp32 (exact: a product of two bf16 values), dm_c = dya_c @ W[c]^T
// in fp32 rounded to bf16, the A terms added in bf16, last component first
// (the order in which JAX's backward pass accumulates the cotangent of m).
// attr_c leaves the sum over D (dm_c = attr_c * (dy @ W[c]^T), one more fp32
// rounding), so the A fragments are the unscaled dy rows, loaded once.  Each
// column tile's product over D completes in a fresh fp32 accumulator before
// it is rounded and added.  Rounded to bf16 into Out (columns up to C1
// rounded to 8).
__device__ void layer_bwd_vjp_mma(const bf16* __restrict__ Wk, int c1, int dd, const Dims& d,
                                  const bf16* DY, bf16* Wt, bf16* Out, const bf16* geo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const int kp = round_up(c1, 16), dpl = round_up(dd, 16);
  const int ds_n = dpl / 16, ct_n = (c1 + 7) / 8;
  __syncthreads();
  load_slice(Wk, d.a - 1, dpl, kp, d.ldw, Wt);
  const bf16* a0 = DY + (r0 + g) * d.ldy + t4 * 2;
  const bf16* a1 = a0 + 8 * d.ldy;
  uint32_t af[kMaxDS][4];
#pragma unroll
  for (int ds = 0; ds < kMaxDS; ++ds) {
    if (ds < ds_n) {
      af[ds][0] = *reinterpret_cast<const uint32_t*>(a0 + ds * 16);
      af[ds][1] = *reinterpret_cast<const uint32_t*>(a1 + ds * 16);
      af[ds][2] = *reinterpret_cast<const uint32_t*>(a0 + ds * 16 + 8);
      af[ds][3] = *reinterpret_cast<const uint32_t*>(a1 + ds * 16 + 8);
    }
  }
  float acc[kMaxCT][4];  // the running bf16 sum, held in fp32
#pragma unroll
  for (int ct = 0; ct < kMaxCT; ++ct) acc[ct][0] = acc[ct][1] = acc[ct][2] = acc[ct][3] = 0.f;
  for (int i = 0; i < d.a; ++i) {
    const int c = d.a - 1 - i;
    const bf16* cur = Wt + (i & 1) * d.wbuf;
    if (i + 1 < d.a) {
      load_slice(Wk, c - 1, dpl, kp, d.ldw, Wt + ((i + 1) & 1) * d.wbuf);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float at0 = to_f(geo[(r0 + g) * d.gs + c]), at1 = to_f(geo[(r0 + g + 8) * d.gs + c]);
#pragma unroll
    for (int ct = 0; ct < kMaxCT; ++ct) {
      if (ct < ct_n) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ds = 0; ds < kMaxDS; ++ds) {
          if (ds < ds_n) {
            uint32_t b0, b1;
            ldsm_x2_t(b0, b1, cur + (ds * 16 + (lane & 15)) * d.ldw + ct * 8);
            mma_bf16_16816(t, af[ds], b0, b1);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float dmc = rnd<bf16>(__fmul_rn(q < 2 ? at0 : at1, t[q]));
          acc[ct][q] = i == 0 ? dmc : rnd<bf16>(__fadd_rn(acc[ct][q], dmc));
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int ct = 0; ct < kMaxCT; ++ct) {
    if (ct < ct_n) {
      const int col = ct * 8 + t4 * 2;
      *reinterpret_cast<__nv_bfloat162*>(Out + (r0 + g) * d.ldm + col) =
          __floats2bfloat162_rn(acc[ct][0], acc[ct][1]);
      *reinterpret_cast<__nv_bfloat162*>(Out + (r0 + g + 8) * d.ldm + col) =
          __floats2bfloat162_rn(acc[ct][2], acc[ct][3]);
    }
  }
}

// the natural-layout slice W[c] [C1][D] into Ws [C1][ldw], zero past D
template <typename T>
__device__ __forceinline__ void stage_slice_fma(const T* __restrict__ W, int c, int c1, int dd,
                                                const Dims& d, T* Ws) {
  const T* Wc = W + (long)c * c1 * dd;
  for (int idx = threadIdx.x; idx < c1 * d.ldw; idx += blockDim.x) {
    const int kk = idx / d.ldw, nn = idx % d.ldw;
    Ws[idx] = nn < dd ? Wc[(long)kk * dd + nn] : from_f<T>(0.f);
  }
}

// y = sum_c attr_c * (M @ W[c]) on the FMA units, the arithmetic of kernel
// #8's layer_fma (the sum over c in registers here), rounded into Y (columns
// up to D rounded to 16; the pad is zero).
template <typename T>
__device__ void layer_fwd_fma(const T* __restrict__ W, int c1, int dd, const Dims& d,
                              const T* M, T* Ws, T* Y, const T* geo) {
  const int cg_n = (dd + kCT - 1) / kCT;
  const int items = (d.rows / kRT) * cg_n;
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
      const int item = threadIdx.x + it * blockDim.x;
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
          for (int j = 0; j < kCT; ++j) w[j] = to_f(Ws[kk * d.ldw + j0 + j]);
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
  const int dpl = round_up(dd, 16);
#pragma unroll
  for (int it = 0; it < kItChain; ++it) {
    const int item = threadIdx.x + it * blockDim.x;
    if (item < items) {
      const int r0 = (item / cg_n) * kRT, j0 = (item % cg_n) * kCT;
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int j = 0; j < kCT; ++j) Y[(r0 + i) * d.ldy + j0 + j] = from_f<T>(y[it][i][j]);
    }
  }
  for (int w = threadIdx.x; w < d.rows * dpl; w += blockDim.x) {  // zero pad past D4
    const int r = w / dpl, j = w % dpl;
    if (j >= cg_n * kCT) Y[r * d.ldy + j] = from_f<T>(0.f);
  }
}

// dm = sum_c (dy * attr_c, rounded) @ W[c]^T on the FMA units, rounded into
// Out (columns up to C1 rounded to 4).
template <typename T>
__device__ void layer_bwd_fma(const T* __restrict__ W, int c1, int dd, const Dims& d,
                              const T* DY, T* Ws, T* Out, const T* geo) {
  const int cq_n = (c1 + kCT - 1) / kCT;
  const int items = (d.rows / kRT) * cq_n;
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
      const int item = threadIdx.x + it * blockDim.x;
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
            w[j] = k0 + j < c1 ? to_f(Ws[(k0 + j) * d.ldw + dd_]) : 0.f;
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
    const int item = threadIdx.x + it * blockDim.x;
    if (item < items) {
      const int r0 = (item / cq_n) * kRT, k0 = (item % cq_n) * kCT;
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int j = 0; j < kCT; ++j) Out[(r0 + i) * d.ldm + k0 + j] = from_f<T>(acc[it][i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// The gate and its VJP (Gate.fast_apply: out_j = y_j * sigmoid(y)[sel_j]).

// the forward gate of lane j from a row of y in the data type (kernel #8's
// gate_out)
template <typename T>
__device__ __forceinline__ float gate_out(const T* yrow, const int* sel, int j) {
  const float s = rnd<T>(sigmoid_f(to_f(yrow[sel[j]])));
  return rnd<T>(__fmul_rn(to_f(yrow[j]), s));
}

// Per row (a warp each), dy over y in place, as JAX's AD differentiates
// fast_apply in the data type:
//   direct_j = rnd(dout_j * mult_j),  dmlt_j = rnd(dout_j * y_j)          (j < dk)
//   dsg_s    = rnd(fp32 sum of dmlt_j over the lanes j with sel_j = s)
//   dsig_s   = rnd(dsg_s * (sig_s * (1 - sig_s))),  sig_s = sigmoid(y_s) in fp32
//   dy_s     = rnd(direct_s + dsig_s) for s < dk, dsig_s after; zero to dpad.
// invs/invl: for each sigmoid lane s, the lanes j (ascending) with sel_j = s.
template <typename T, typename Dout>
__device__ void gate_vjp(T* Y, int dd, int dk, const int* sel, const int* invs, const int* invl,
                         float* scratch, const Dims& d, Dout dout) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* dml = scratch + warp * kMaxD;
  const int dpad = round_up(dd, 16);
  for (int r = warp; r < d.rows; r += kWarps) {
    T* y = Y + r * d.ldy;
    float direct[kMaxLanes];
#pragma unroll
    for (int q = 0; q < kMaxLanes; ++q) {
      const int j = lane + 32 * q;
      direct[q] = 0.f;
      if (j < dk) {
        const float o = dout(r, j);
        const float m = rnd<T>(sigmoid_f(to_f(y[sel[j]])));
        direct[q] = rnd<T>(__fmul_rn(o, m));
        dml[j] = rnd<T>(__fmul_rn(o, to_f(y[j])));
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kMaxLanes; ++q) {
      const int s = lane + 32 * q;
      if (s < dpad) {
        float v = 0.f;
        if (s < dd) {
          float sum = 0.f;
          for (int p = invs[s]; p < invs[s + 1]; ++p) sum = __fadd_rn(sum, dml[invl[p]]);
          const float sg = sigmoid_f(to_f(y[s]));
          const float dsig = rnd<T>(__fmul_rn(rnd<T>(sum), __fmul_rn(sg, __fsub_rn(1.f, sg))));
          v = s < dk ? rnd<T>(__fadd_rn(direct[q], dsig)) : dsig;
        }
        y[s] = from_f<T>(v);
      }
    }
    __syncwarp();
  }
}

// the inverse selection of both layers: counts in parallel, the prefix sum
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
// warp per row; s, rn < 0: zero rows)
template <typename T>
__device__ __forceinline__ void m0_row(const T* __restrict__ hs, const T* __restrict__ h, int f,
                                       int s, int rn, float d2, T* mrow, int width, int lane) {
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

// rows [rows][ld] of shared memory into out [N*K][width] (width a multiple of
// 16 bytes), rows of real receivers only, 16 bytes per thread
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

// ---------------------------------------------------------------------------
// 1. The chain: kernel #9 (Mode::kResidual) and #10 (Mode::kReplay) with TAB
// (senders through loc/gtab, rows of h; d_hs node-major), #12, #13 and #14
// (Mode::kVjp) without (slot k of receiver i reads row k*N + i of hs [K, N, F]
// and writes d_hs there).  kVjp replays as kReplay and differs in the dm
// GEMMs' rounding (layer_bwd_vjp_mma); in fp32 that rounding is the identity,
// so the fp32 instance of kVjp is kReplay's.
enum class Mode { kResidual, kReplay, kVjp };

template <typename T, bool MMA, Mode MODE, bool TAB>
__global__ void __launch_bounds__(kThreads, 1)
chain_kernel(const T* __restrict__ hs, const T* __restrict__ h, const T* __restrict__ geo2,
             const int* __restrict__ loc, const int* __restrict__ gtab,
             const T* __restrict__ w1, const int* __restrict__ sel1g,
             const T* __restrict__ w2, const int* __restrict__ sel2g, const T* __restrict__ y1in,
             const T* __restrict__ y2in, const T* __restrict__ dagg, T* __restrict__ dhs,
             T* __restrict__ dhr, T* __restrict__ dy1g, T* __restrict__ dy2g,
             T* __restrict__ m0g, T* __restrict__ m1g, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* p = smem_raw;
  T* geo = reinterpret_cast<T*>(p);  // [rows][a+2]: attr, d2, mask
  p += align16((long)sizeof(T) * d.rows * d.gs);
  int* snd = reinterpret_cast<int*>(p);
  int* rnode = snd + d.rows;
  int* sel1 = rnode + d.rows;
  int* sel2 = sel1 + d.dk1;
  int* inv1s = sel2 + d.dk2;
  int* inv1l = inv1s + d.da + 1;
  int* inv2s = inv1l + d.dk1;
  int* inv2l = inv2s + d.db + 1;
  p += align16(4L * chain_ints(d));
  float* scratch = reinterpret_cast<float*>(p);  // [warps][kMaxD]
  p += align16(4L * kWarps * kMaxD);
  T* M = reinterpret_cast<T*>(p);  // [rows][ldm]: m, then dm
  p += align16((long)sizeof(T) * d.rows * d.ldm);
  T* Y1 = reinterpret_cast<T*>(p);  // [rows][ldy]: y_1, then dy_1
  p += align16((long)sizeof(T) * d.rows * d.ldy);
  T* Y2 = reinterpret_cast<T*>(p);  // [rows][ldy]: y_2, then dy_2
  p += align16((long)sizeof(T) * d.rows * d.ldy);
  T* Wsl = reinterpret_cast<T*>(p);

  const int node0 = blockIdx.x * d.rb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a = d.a, f = d.f;
  for (int j = threadIdx.x; j < d.dk1; j += blockDim.x) sel1[j] = sel1g[j];
  for (int j = threadIdx.x; j < d.dk2; j += blockDim.x) sel2[j] = sel2g[j];
  // ---- per-row receiver, sender and geometry
  for (int r = threadIdx.x; r < d.rows; r += blockDim.x) {
    const int node = node0 + r / d.k;
    int s = -1, rn = -1;
    if (r < d.rb * d.k && node < d.n) {
      rn = node;
      const long e = (long)node * d.k + r % d.k;
      if constexpr (TAB) s = sender_of(loc, gtab, node, e, d);
      else s = (r % d.k) * d.n + node;  // the host checks K*N < 2^31
      for (int q = 0; q < d.gs; ++q) geo[r * d.gs + q] = geo2[e * d.gs + q];
    } else {
      for (int q = 0; q < d.gs; ++q) geo[r * d.gs + q] = from_f<T>(0.f);
    }
    snd[r] = s;
    rnode[r] = rn;
  }
  __syncthreads();
  build_inverse(sel1, d.dk1, d.da, inv1s, inv1l);
  build_inverse(sel2, d.dk2, d.db, inv2s, inv2l);
  const long e0 = (long)node0 * d.k;  // the block's first slot row
  constexpr bool kReplays = MODE != Mode::kResidual;
  if constexpr (!kReplays) {
    // ---- the saved y of both layers (zero rows past the receivers, zero pad)
    const int p1 = round_up(d.da, 16), p2 = round_up(d.db, 16);
    for (int w = threadIdx.x; w < d.rows * p1; w += blockDim.x) {
      const int r = w / p1, j = w % p1;
      Y1[r * d.ldy + j] = (rnode[r] >= 0 && j < d.da) ? y1in[(e0 + r) * d.da + j] : from_f<T>(0.f);
    }
    for (int w = threadIdx.x; w < d.rows * p2; w += blockDim.x) {
      const int r = w / p2, j = w % p2;
      Y2[r * d.ldy + j] = (rnode[r] >= 0 && j < d.db) ? y2in[(e0 + r) * d.db + j] : from_f<T>(0.f);
    }
  }
  // ---- m_0 and m_1 of every slot row, for the weight-gradient kernel (and,
  // in replay mode, the forward of kernel #8 for these rows: y_1, y_2)
  for (int r = warp; r < d.rows; r += kWarps)
    m0_row<T>(hs, h, f, snd[r], rnode[r], to_f(geo[r * d.gs + a]), M + r * d.ldm, d.ldm - 8,
              lane);
  __syncthreads();
  store_rows<T>(m0g, d.kp0, M, d.ldm, rnode, e0, d);
  if constexpr (kReplays) {
    if constexpr (MMA) layer_fwd_mma(w1, d.c1a, d.da, d, M, Wsl, Y1, geo);
    else layer_fwd_fma<T>(w1, d.c1a, d.da, d, M, Wsl, Y1, geo);
  }
  __syncthreads();
  for (int r = warp; r < d.rows; r += kWarps) {
    for (int j = lane; j < d.ldm - 8; j += 32)
      M[r * d.ldm + j] = from_f<T>(j < d.dk1 ? gate_out<T>(Y1 + r * d.ldy, sel1, j) : 0.f);
  }
  __syncthreads();
  store_rows<T>(m1g, d.kp1, M, d.ldm, rnode, e0, d);
  if constexpr (kReplays) {
    if constexpr (MMA) layer_fwd_mma(w2, d.c1b, d.db, d, M, Wsl, Y2, geo);
    else layer_fwd_fma<T>(w2, d.c1b, d.db, d, M, Wsl, Y2, geo);
  }
  __syncthreads();
  // ---- layer 2: dm_2 = rnd(d_agg * mask), the gate VJP in place, dm_1
  gate_vjp<T>(Y2, d.db, d.dk2, sel2, inv2s, inv2l, scratch, d, [&](int r, int j) {
    const int rn = rnode[r];
    return rn < 0 ? 0.f
                  : rnd<T>(__fmul_rn(to_f(dagg[(long)rn * d.dk2 + j]),
                                     to_f(geo[r * d.gs + a + 1])));
  });
  __syncthreads();
  for (int w = threadIdx.x; w < d.rows * d.ldg2; w += blockDim.x) {
    const int r = w / d.ldg2, j = w % d.ldg2;
    if (rnode[r] >= 0) dy2g[(e0 + r) * d.ldg2 + j] = Y2[r * d.ldy + j];
  }
  if constexpr (MMA && MODE == Mode::kVjp) layer_bwd_vjp_mma(w2, d.c1b, d.db, d, Y2, Wsl, M, geo);
  else if constexpr (MMA) layer_bwd_mma(w2, d.c1b, d.db, d, Y2, Wsl, M, geo);
  else layer_bwd_fma<T>(w2, d.c1b, d.db, d, Y2, Wsl, M, geo);
  __syncthreads();
  // ---- layer 1: the gate VJP at y_1 with dout = dm_1, then dm_0
  gate_vjp<T>(Y1, d.da, d.dk1, sel1, inv1s, inv1l, scratch, d,
              [&](int r, int j) { return to_f(M[r * d.ldm + j]); });
  __syncthreads();
  for (int w = threadIdx.x; w < d.rows * d.ldg1; w += blockDim.x) {
    const int r = w / d.ldg1, j = w % d.ldg1;
    if (rnode[r] >= 0) dy1g[(e0 + r) * d.ldg1 + j] = Y1[r * d.ldy + j];
  }
  if constexpr (MMA && MODE == Mode::kVjp) layer_bwd_vjp_mma(w1, d.c1a, d.da, d, Y1, Wsl, M, geo);
  else if constexpr (MMA) layer_bwd_mma(w1, d.c1a, d.da, d, Y1, Wsl, M, geo);
  else layer_bwd_fma<T>(w1, d.c1a, d.da, d, Y1, Wsl, M, geo);
  __syncthreads();
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
// 2. The weight gradients: block (c, range, layer) sums m_l^T rnd(dy_l attr_c)
// over its slot rows into the fp32 tile [C1][D] of partials[range].  The
// chain wrote m_l and dy_l per slot row; chunks of 64 rows stream in by
// cp.async into a double buffer (chunk i+1 loads while chunk i multiplies),
// and dy is scaled by attr_c in shared memory.
// TILES (kernel #14, JAX's AD of _layer_tp): range sp is the backward tile
// tile0 + sp (trows slot rows), dya = dy_l attr_c stays fp32 and the tile's
// fp32 sum is rounded to the data type, as the TPU kernel's per-grid-step
// dW'.  In bf16 dya (a product of two bf16 values, 16 significant bits) is
// split into hi = rnd(dya) and lo = rnd(dya - hi), both exact, and each
// multiplies on the tensor cores: the products stay exact.
template <typename T, bool MMA, bool TILES>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_kernel(const T* __restrict__ geo2, const T* __restrict__ m0g, const T* __restrict__ m1g,
             const T* __restrict__ dy1, const T* __restrict__ dy2, float* __restrict__ partials,
             Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* p = smem_raw;
  T* Mb = reinterpret_cast<T*>(p);  // [2][kChunk][ldm]: m_l rows
  p += 2 * align16((long)sizeof(T) * kChunk * d.ldm);
  T* Zb = reinterpret_cast<T*>(p);  // [2][kChunk][ldz]: dy rows, then rnd(dy * attr_c)
  p += 2 * align16((long)sizeof(T) * kChunk * d.ldz);
  T* Zlo = reinterpret_cast<T*>(p);  // TILES, bf16: [kChunk][ldz] the low halves
  if (TILES) p += align16((long)sizeof(T) * kChunk * d.ldz);
  float* att = reinterpret_cast<float*>(p);  // [2][kChunk]: attr_c per row

  const int c = blockIdx.x, sp = blockIdx.y, layer = blockIdx.z;
  const int c1 = layer ? d.c1b : d.c1a, dd = layer ? d.db : d.da;
  const int kp = layer ? d.kp1 : d.kp0;
  const T* mg = layer ? m1g : m0g;
  const T* dy = layer ? dy2 : dy1;
  const int ldg = layer ? d.ldg2 : d.ldg1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long rows_total = (long)d.n * d.k;
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
  constexpr bool kSplit = TILES && MMA;  // dya as hi + lo
  const int dpl = round_up(dd, 16);
  const long mbuf = align16((long)sizeof(T) * kChunk * d.ldm) / sizeof(T);
  const long zbuf = align16((long)sizeof(T) * kChunk * d.ldz) / sizeof(T);
  constexpr int V = 16 / sizeof(T);

  // dy columns past its global row (ldg .. D16) stay zero in every buffer
  const int nz = kSplit ? 3 : 2;
  for (int w = threadIdx.x; w < nz * kChunk * (dpl - ldg); w += blockDim.x) {
    const int b = w / (kChunk * (dpl - ldg)), x = w % (kChunk * (dpl - ldg));
    T* Z = b < 2 ? Zb + b * zbuf : Zlo;
    Z[(x / (dpl - ldg)) * d.ldz + ldg + x % (dpl - ldg)] = from_f<T>(0.f);
  }
  // the chunk of rows from e0 into buffer b: its m and dy rows by cp.async
  // (zero rows past r1), its attr_c by plain loads
  auto load_chunk = [&](long e0, int b) {
    T* M = Mb + b * mbuf;
    T* Z = Zb + b * zbuf;
    for (int w = threadIdx.x; w < kChunk * (kp / V); w += blockDim.x) {
      const int r = w / (kp / V), q = (w % (kp / V)) * V;
      if (e0 + r < r1) cp_async16(M + r * d.ldm + q, mg + (e0 + r) * kp + q);
      else *reinterpret_cast<uint4*>(M + r * d.ldm + q) = make_uint4(0, 0, 0, 0);
    }
    for (int w = threadIdx.x; w < kChunk * (ldg / V); w += blockDim.x) {
      const int r = w / (ldg / V), q = (w % (ldg / V)) * V;
      if (e0 + r < r1) cp_async16(Z + r * d.ldz + q, dy + (e0 + r) * ldg + q);
      else *reinterpret_cast<uint4*>(Z + r * d.ldz + q) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
    if (threadIdx.x < kChunk) {
      const long e = e0 + threadIdx.x;
      att[b * kChunk + threadIdx.x] = e < r1 ? to_f(geo2[e * d.gs + c]) : 0.f;
    }
  };

  // mma: warps 4 (C1) x 2 (D); fma: 4 x 4 work items over [C1][D]
  const int mt_n = kp / 16, nt_n = dpl / 8;
  const int mtw = (mt_n + 3) / 4, ntw = (nt_n + 1) / 2;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int mq_n = (c1 + 3) / 4, nq_n = (dd + 3) / 4, items = mq_n * nq_n;
  float acc[MMA ? kWMT : kItW][MMA ? kWNT : kRT][MMA ? 4 : kCT];
#pragma unroll
  for (int x = 0; x < (MMA ? kWMT : kItW); ++x)
#pragma unroll
    for (int y = 0; y < (MMA ? kWNT : kRT); ++y)
#pragma unroll
      for (int z = 0; z < (MMA ? 4 : kCT); ++z) acc[x][y][z] = 0.f;

  __syncthreads();
  if (r0 < r1) load_chunk(r0, 0);
  for (long e0 = r0; e0 < r1; e0 += kChunk) {
    const int b = (int)(((e0 - r0) / kChunk) & 1);
    if (e0 + kChunk < r1) {
      load_chunk(e0 + kChunk, b ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the chunk has landed for every thread
    const T* M = Mb + b * mbuf;
    T* Z = Zb + b * zbuf;
    for (int w = threadIdx.x; w < kChunk * ldg; w += blockDim.x) {
      const int r = w / ldg, j = w % ldg;
      const float v = __fmul_rn(to_f(Z[r * d.ldz + j]), att[b * kChunk + r]);
      Z[r * d.ldz + j] = from_f<T>(v);
      if constexpr (kSplit) Zlo[r * d.ldz + j] = from_f<T>(__fsub_rn(v, rnd<T>(v)));
    }
    __syncthreads();
    if constexpr (MMA) {
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        uint32_t af[kWMT][4];
#pragma unroll
        for (int mi = 0; mi < kWMT; ++mi) {
          const int mt = wm * mtw + mi;
          if (mi < mtw && mt < mt_n) {
            const int q = lane >> 3, i = lane & 7;
            ldsm_x4_t(af[mi], M + (ks * 16 + i + (q >> 1) * 8) * d.ldm + mt * 16 + (q & 1) * 8);
          }
        }
#pragma unroll
        for (int ni = 0; ni < kWNT; ++ni) {
          const int nt = wn * ntw + ni;
          if (ni < ntw && nt < nt_n) {
            uint32_t b0, b1;
            ldsm_x2_t(b0, b1, Z + (ks * 16 + (lane & 15)) * d.ldz + nt * 8);
#pragma unroll
            for (int mi = 0; mi < kWMT; ++mi)
              if (mi < mtw && wm * mtw + mi < mt_n) mma_bf16_16816(acc[mi][ni], af[mi], b0, b1);
            if constexpr (kSplit) {
              ldsm_x2_t(b0, b1, Zlo + (ks * 16 + (lane & 15)) * d.ldz + nt * 8);
#pragma unroll
              for (int mi = 0; mi < kWMT; ++mi)
                if (mi < mtw && wm * mtw + mi < mt_n) mma_bf16_16816(acc[mi][ni], af[mi], b0, b1);
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
            for (int i = 0; i < kRT; ++i) x[i] = to_f(M[r * d.ldm + m0 + i]);
#pragma unroll
            for (int j = 0; j < kCT; ++j) z[j] = to_f(Z[r * d.ldz + n0 + j]);
#pragma unroll
            for (int i = 0; i < kRT; ++i)
#pragma unroll
              for (int j = 0; j < kCT; ++j) acc[it][i][j] = fmaf(x[i], z[j], acc[it][i][j]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with buffer b before it refills
  }
  // ---- this range's tile of dW_layer[c] (rows c*C1 + m of W' [A*C1, D])
  const long nw = (long)d.a * ((long)d.c1a * d.da + (long)d.c1b * d.db);
  float* out = partials + sp * nw + (layer ? (long)d.a * d.c1a * d.da : 0L) + (long)c * c1 * dd;
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
            if (m < c1 && n < dd) out[(long)m * dd + n] = TILES ? rnd<T>(acc[mi][ni][q])
                                                                 : acc[mi][ni][q];
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
            if (m0 + i < c1 && n0 + j < dd)
              out[(long)(m0 + i) * dd + n0 + j] = TILES ? rnd<T>(acc[it][i][j]) : acc[it][i][j];
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

// -1 for shapes the kernels do not take, else the chain's and the weight-
// gradient kernel's shared memory, the larger
long smem_for(int dtype, int k, int a, int c1a, int da, int c1b, int db) {
  if (k < 1 || a < 1 || c1a < 1 || c1b < 1 || da < 1 || db < 1) return -1;
  if (c1a > kMaxC1 || c1b > kMaxC1 || da > kMaxD || db > kMaxD) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  const Dims d = make_dims(dtype == 1, 1, 0, k, a, 1, 1, c1a, da, da, c1b, db, db);
  if (d.rb < 1) return -1;
  const long cs = dtype == 1 ? chain_smem<bf16>(d) : chain_smem<float>(d);
  const long ws = dtype == 1 ? wgrad_smem<bf16>(d, true) : wgrad_smem<float>(d, true);
  return cs > ws ? cs : ws;
}

template <typename K>
cudaError_t set_smem(K kern, long smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, bool MMA, Mode MODE, bool TAB>
int launch_chain(const Dims& d, const void* const* in, void* const* out, cudaStream_t st) {
  const long smem = chain_smem<T>(d);
  auto kern = chain_kernel<T, MMA, MODE, TAB>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (d.n + d.rb - 1) / d.rb;
  if (grid < 1) return 0;
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]), static_cast<const T*>(in[2]),
      static_cast<const int*>(in[3]), static_cast<const int*>(in[4]),
      static_cast<const T*>(in[5]), static_cast<const int*>(in[6]),
      static_cast<const T*>(in[7]), static_cast<const int*>(in[8]),
      static_cast<const T*>(in[9]), static_cast<const T*>(in[10]),
      static_cast<const T*>(in[11]), static_cast<T*>(out[0]),
      static_cast<T*>(out[1]), static_cast<T*>(out[2]), static_cast<T*>(out[3]),
      static_cast<T*>(out[4]), static_cast<T*>(out[5]), d);
  return (int)cudaGetLastError();
}

template <typename T, bool MMA, bool TILES>
int launch_wgrad(const Dims& d, const void* const* in, float* partials, cudaStream_t st) {
  const long smem = wgrad_smem<T>(d, TILES);
  auto kern = wgrad_kernel<T, MMA, TILES>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  if ((long)d.n * d.k < 1 || d.splits < 1) return 0;
  kern<<<dim3(d.a, d.splits, 2), kThreads, smem, st>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]), static_cast<const T*>(in[2]),
      static_cast<const T*>(in[3]), static_cast<const T*>(in[4]), partials, d);
  return (int)cudaGetLastError();
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

// Shared memory one block of the chain or weight-gradient kernel needs
// (bytes, the larger), or -1 for shapes the kernels do not take (C1 > 192 or
// D > 128 among them); the wrapper checks it against the card's limit.
long fused_message_generic_tab_bwd_smem_bytes(int dtype, int k, int a, int c1a, int da, int c1b,
                                              int db) {
  return smem_for(dtype, k, a, c1a, da, c1b, db);
}

// The chain: kernel #10 (replay = 1: y recomputed) or #9 (replay = 0:
// y1in/y2in are the saved [N*K, D] ys).  dtype: 0 = float32 (FMA engine,
// weights [A*C1][D]), 1 = bfloat16 (tensor cores, weights [A][D rounded up to
// 16][C1 rounded up to 16]).  Outputs d_hs [N*K, F], d_hr [N, F], dy1/dy2
// [N*K, D rounded up to 8] and, for the weight-gradient kernel, m0/m1 [N*K,
// C1 rounded up to 16] (zero-padded).  Returns cudaGetLastError() after the
// launch.
int fused_message_generic_tab_bwd_chain(int dtype, int replay, const void* h, const void* geo2,
                                        const void* loc, const void* gtab, const void* w1,
                                        const void* sel1, const void* w2, const void* sel2,
                                        const void* y1in, const void* y2in, const void* dagg,
                                        void* dhs, void* dhr, void* dy1, void* dy2, void* m0,
                                        void* m1,
                                        int n, int f, int k, int a, int tile, int u, int c1a,
                                        int da, int dk1, int c1b, int db, int dk2, void* stream) {
  if (smem_for(dtype, k, a, c1a, da, c1b, db) < 0) return (int)cudaErrorInvalidValue;
  if (dk1 > da || dk2 > db || dk1 != c1b || 2 * f + 1 != c1a) return (int)cudaErrorInvalidValue;
  if (!replay && (y1in == nullptr || y2in == nullptr)) return (int)cudaErrorInvalidValue;
  const void* in[12] = {h, h, geo2, loc, gtab, w1, sel1, w2, sel2, y1in, y2in, dagg};
  void* out[6] = {dhs, dhr, dy1, dy2, m0, m1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d = make_dims(dtype == 1, n, f, k, a, tile, u, c1a, da, dk1, c1b, db, dk2);
  if (dtype == 0)
    return replay ? launch_chain<float, false, Mode::kReplay, true>(d, in, out, st)
                  : launch_chain<float, false, Mode::kResidual, true>(d, in, out, st);
  return replay ? launch_chain<bf16, true, Mode::kReplay, true>(d, in, out, st)
                : launch_chain<bf16, true, Mode::kResidual, true>(d, in, out, st);
}

// The untabled chain: kernel #12 (mode = 0, y1in/y2in the saved ys), #13
// (mode = 1, replay) or #14's chain (mode = 2, replay with JAX's AD rounding
// of the dm GEMMs).  hs [K, N, F] slot-major sender rows, h [N, F] the
// receivers; d_hs comes out [K, N, F], the other outputs as above.
int fused_message_generic_bwd_chain(int dtype, int mode, const void* hs, const void* h,
                                    const void* geo2, const void* w1, const void* sel1,
                                    const void* w2, const void* sel2, const void* y1in,
                                    const void* y2in, const void* dagg, void* dhs, void* dhr,
                                    void* dy1, void* dy2, void* m0, void* m1, int n, int f,
                                    int k, int a, int c1a, int da, int dk1, int c1b, int db,
                                    int dk2, void* stream) {
  if (smem_for(dtype, k, a, c1a, da, c1b, db) < 0) return (int)cudaErrorInvalidValue;
  if (dk1 > da || dk2 > db || dk1 != c1b || 2 * f + 1 != c1a) return (int)cudaErrorInvalidValue;
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  if (mode == 0 && (y1in == nullptr || y2in == nullptr)) return (int)cudaErrorInvalidValue;
  if ((long)k * n > 2147483647L) return (int)cudaErrorInvalidValue;
  const void* in[12] = {hs, h, geo2, nullptr, nullptr, w1, sel1, w2, sel2, y1in, y2in, dagg};
  void* out[6] = {dhs, dhr, dy1, dy2, m0, m1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d = make_dims(dtype == 1, n, f, k, a, 1, 0, c1a, da, dk1, c1b, db, dk2);
  if (dtype == 0)
    return mode ? launch_chain<float, false, Mode::kReplay, false>(d, in, out, st)
                : launch_chain<float, false, Mode::kResidual, false>(d, in, out, st);
  if (mode == 2) return launch_chain<bf16, true, Mode::kVjp, false>(d, in, out, st);
  return mode ? launch_chain<bf16, true, Mode::kReplay, false>(d, in, out, st)
              : launch_chain<bf16, true, Mode::kResidual, false>(d, in, out, st);
}

// The weight gradients: partials [splits, NW] fp32, NW = A (C1a Da + C1b Db),
// each row the sum over one range of slot rows (W' layouts [A*C1, D] one after
// the other), from the chain's m0/m1 and dy1/dy2 and the attributes in geo2.
int fused_message_generic_tab_bwd_wgrad(int dtype, const void* geo2, const void* m0,
                                        const void* m1, const void* dy1, const void* dy2,
                                        void* partials, int n, int k, int a, int c1a, int da,
                                        int c1b, int db, int splits, void* stream) {
  if (smem_for(dtype, k, a, c1a, da, c1b, db) < 0 || splits < 1) return (int)cudaErrorInvalidValue;
  Dims d = make_dims(dtype == 1, n, 0, k, a, 1, 1, c1a, da, da, c1b, db, db);
  d.splits = splits;
  const void* in[5] = {geo2, m0, m1, dy1, dy2};
  float* part = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_wgrad<float, false, false>(d, in, part, st);
  return launch_wgrad<bf16, true, false>(d, in, part, st);
}

// Kernel #14's weight gradients: partials [ntiles, NW] fp32, row t the sum over
// the slot rows of backward tile tile0 + t (tile_rows of them; the last tile
// may be short) of m_l^T (dy_l attr_c), dya in fp32, rounded to the data type;
// layouts as above.
int fused_message_generic_bwd_wgrad_tiles(int dtype, const void* geo2, const void* m0,
                                          const void* m1, const void* dy1, const void* dy2,
                                          void* partials, int n, int k, int a, int c1a, int da,
                                          int c1b, int db, int tile_rows, int tile0, int ntiles,
                                          void* stream) {
  if (smem_for(dtype, k, a, c1a, da, c1b, db) < 0 || tile_rows < 1 || tile0 < 0 || ntiles < 0)
    return (int)cudaErrorInvalidValue;
  if ((long)(tile0 + ntiles - 1) * tile_rows >= (long)n * k && ntiles > 0)
    return (int)cudaErrorInvalidValue;
  Dims d = make_dims(dtype == 1, n, 0, k, a, 1, 1, c1a, da, da, c1b, db, db);
  d.splits = ntiles;
  d.trows = tile_rows;
  d.tile0 = tile0;
  const void* in[5] = {geo2, m0, m1, dy1, dy2};
  float* part = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_wgrad<float, false, true>(d, in, part, st);
  return launch_wgrad<bf16, true, true>(d, in, part, st);
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

}  // extern "C"
