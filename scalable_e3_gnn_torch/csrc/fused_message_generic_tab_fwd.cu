// Generic fused message + aggregation, forward, for Hopper (sm_90a): the
// tabled and the untabled sender addressing, one kernel template.
//
// Replaces the TPU kernels scalable_e3_gnn_tpu/kernels/fused_message_generic.py::
// FusedMessageGeneric._fwd_call_tab (#8: senders through per-tile tables) and
// _fwd_call (#11: senders as a slot-major [K, N, F] operand), their body
// _message / _message_stages with _layer_tp and Gate.fast_apply.  For every
// receiver i and neighbour slot k:
//
//   m0     = [x_s || h[i] || d2[i,k]]                                 (C1 = 2F+1)
//   y_l    = sum_c (m_l @ W_l[c]) * attr_c[i,k]                       (c < A)
//   m_l+1  = y_l[:, :dk_l] * sigmoid(y_l)[:, sel_l]                   (l = 0, 1)
//   agg[i] = sum_k mask[i,k] * m_2
//
// with the sender row x_s = h[gtab[i / tile, loc[i,k]]] (tabled, #8; loc == U
// means no sender: a zero row) or x_s = hs[k, i] (untabled, #11; every slot is
// read, masked slots carry some real row and their mask zeroes the message).
//
// With y1/y2 given (the save mode, for the residual backward) the kernel also
// writes each layer's pre-gate y_l, rounded to the data type, one row per
// slot: y_l[i*K + k] (node-major [N*K, D_l], in both modes; the TPU kernel #11
// writes [K, N, D_l], a layout only its own backward reads).
//
// W_l [A*C1_l, D_l] are the CG-folded weights with their columns permuted to
// scalars || gated || gates, sel_l [dk_l] the sigmoid lane of each gate output
// (the TPU kernel's 0/1 selection matmul with psel, as a lookup: one 1 per
// column, so the result is bitwise the same).  The TPU kernel #8 expands a
// per-tile table hu = h[gtab] to slot rows with a one-hot matmul; here each
// slot reads its sender row through the table directly, and h (45 MB in bf16
// at 250k x 90) mostly stays in the 50 MB L2.  The untabled kernel reads hs
// once, row by row (one warp per 180-byte bf16 row); hs is K times the size of
// h, so #11 moves more bytes than #8 (1.15 GB per 400k-node chunk at K=16).
// geo2 [N, K*(A+2)] packs attr || d2 || mask per slot.
//
// Rounding points (the TPU kernel's): operands in the data type; each
// component's product accumulated in fp32, scaled by attr_c in fp32 and summed
// over c in fp32, then rounded to the data type (y); sigmoid in fp32 rounded to
// the data type; the gate product, and msg * mask, in the data type; the K-sum
// in fp32; the output rounded to the data type.
//
// Design.  One block owns whole receivers (RB = ROWS / K of them, ROWS slot
// rows), so no sum crosses blocks and there are no atomics.  The folded
// weights do not fit in shared memory (352 KB + 175 KB in bf16 at the lmax=2
// config), so the block keeps its slot rows m_l resident in shared memory and
// streams W_l[c] through shared memory one attribute component at a time; the
// fp32 sum over c stays in registers (bf16) or shared memory (fp32).
// - bf16 (C1 <= 192, D <= 128; wider bf16 widths are not taken): 8 warps x 16
//   rows = 128 rows; each warp runs mma.sync m16n8k16 (bf16 in, fp32
//   accumulate) over its 16 rows and every column.  The wrapper lays W_l out
//   as [A][D8][C16] (transposed, zero-padded to multiples of 8 and 16), so a
//   slice is one contiguous block that cp.async copies in 16-byte pieces into
//   a double buffer: slice c+1 loads while slice c multiplies.  Each B
//   fragment is one 32-bit shared load.
// - fp32 (the check path): 64 rows, each thread a 4 x 4 fp32 FMA tile per work
//   item, W_l[c] [C1][D] in shared memory, the sum over c in a shared
//   [rows][D] fp32 buffer.
//
// Work.  The dense GEMMs run 2 A (C1_0 D_0 + C1_1 D_1) = 526,824 flops per
// valid slot at the lmax=2 config (A=9, C1 = 181 / 90, D = 108), but W_l is
// mostly structural zeros (a block is nonzero only where a CG path and
// coefficient are): the function needs 2 x 30,240 flops per slot there.  This
// version multiplies the dense slices with warp-level mma.sync at one block
// per SM, not the sparse form and not wgmma/TMA with warp specialisation: a
// simple first form; the faster ones are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsMma = 128;  // 8 warps x 16 rows
constexpr int kRowsFma = 64;
constexpr int kMaxKS = 12;  // mma engine: C1 <= 12 x 16 = 192
constexpr int kMaxNT = 16;  // mma engine: D <= 16 x 8 = 128
constexpr int kRT = 4, kCT = 4;  // fma engine: rows x columns per work item

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to the data type and widened back to fp32
template <typename T> __device__ __forceinline__ float round_dt(float x) {
  return to_f(from_f<T>(x));
}

// the fast exponential (a few ulp) and the correctly rounded reciprocal
// (1 / inf = 0 for large negative x)
__device__ __forceinline__ float sigmoid_f(float x) { return __frcp_rn(1.0f + __expf(-x)); }

__device__ __forceinline__ void load4f(const float* p, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline long align16(long bytes) { return (bytes + 15) / 16 * 16; }

struct Dims {
  int n, f, k, a, tile, u;
  int c1a, da, dk1, c1b, db, dk2;
  int rows, rb;  // slot rows per block, receivers per block (rb * k <= rows)
  int c1p, ldm;  // padded layer-input width, its row stride
  int dp, ldw;   // padded layer-output width, the weight slice's row stride
  int ldy, gs;   // y row stride, geometry row width (a + 2)
  int wrows;     // rows of the weight slice(s) in shared memory
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
  if (mma) {
    d.c1p = round_up(c1max, 16);
    d.ldm = d.c1p + 8;  // 32-bit words per row = 4 mod 8: conflict-free fragment loads
    d.dp = round_up(dmax, 8);
    d.ldw = d.ldm;      // each slice is stored transposed, [dp][ldw]
    d.wrows = 2 * d.dp; // two slices: the double buffer
  } else {
    d.c1p = round_up(c1max, 4);
    d.ldm = d.c1p;
    d.dp = round_up(dmax, 4);
    d.ldw = d.dp;       // [c1max][ldw]
    d.wrows = c1max;
  }
  d.ldy = d.dp;
  d.gs = a + 2;
  return d;
}

template <typename T>
__host__ __device__ inline long smem_bytes(const Dims& d) {
  return align16(4L * d.rows * d.ldy) + align16(4L * d.rows * d.gs) +
         align16((long)sizeof(T) * d.rows * d.ldm) + align16((long)sizeof(T) * d.wrows * d.ldw) +
         align16(8L * d.rows);
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// y = sum_c attr_c * (M @ W[c]) on the tensor cores; writes y rounded to bf16
// into Ys.  Wk is [A][dp][kp] (dp = D rounded up to 8, kp = C1 rounded up to
// 16, zero-padded).  Starts with a block barrier (M complete, both weight
// buffers free) and ends with one.
__device__ void layer_mma(const __nv_bfloat16* __restrict__ Wk, int c1, int dd, const Dims& d,
                          const __nv_bfloat16* Ms, __nv_bfloat16* Wt, float* Ys,
                          const float* geo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const int ks_n = (c1 + 15) / 16;
  const int nt_n = (dd + 7) / 8;
  const int kp = ks_n * 16, dp = nt_n * 8;
  const int row_chunks = kp / 8;  // 16-byte pieces per weight row
  const long slice = (long)dp * kp;
  const int buf = d.dp * d.ldw;
  auto load_slice = [&](int c, __nv_bfloat16* dst) {
    const __nv_bfloat16* src = Wk + c * slice;
    for (int i = threadIdx.x; i < dp * row_chunks; i += blockDim.x) {
      const int nn = i / row_chunks, ch = i % row_chunks;
      cp_async16(dst + nn * d.ldw + ch * 8, src + (long)nn * kp + ch * 8);
    }
    cp_async_commit();
  };
  __syncthreads();
  load_slice(0, Wt);
  float acc[kMaxNT][4];
#pragma unroll
  for (int nt = 0; nt < kMaxNT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const __nv_bfloat16* a0 = Ms + (r0 + g) * d.ldm + t4 * 2;
  const __nv_bfloat16* a1 = a0 + 8 * d.ldm;
  for (int c = 0; c < d.a; ++c) {
    const __nv_bfloat16* cur = Wt + (c & 1) * buf;
    if (c + 1 < d.a) {
      load_slice(c + 1, Wt + ((c + 1) & 1) * buf);
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
        const __nv_bfloat16* wb = cur + g * d.ldw + ks * 16 + t4 * 2;
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
    const float at0 = geo[(r0 + g) * d.gs + c], at1 = geo[(r0 + g + 8) * d.gs + c];
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
      float* y0 = Ys + (r0 + g) * d.ldy + col;
      float* y1 = Ys + (r0 + g + 8) * d.ldy + col;
      y0[0] = round_dt<__nv_bfloat16>(acc[nt][0]);
      y0[1] = round_dt<__nv_bfloat16>(acc[nt][1]);
      y1[0] = round_dt<__nv_bfloat16>(acc[nt][2]);
      y1[1] = round_dt<__nv_bfloat16>(acc[nt][3]);
    }
  }
}

// y = sum_c attr_c * (M @ W[c]) on the FMA units; leaves the fp32 sum in Ys
// (the reader rounds it).  Starts with a block barrier (M complete).
template <typename T>
__device__ void layer_fma(const T* __restrict__ W, int c1, int dd, const Dims& d,
                          const T* Ms, T* Ws, float* Ys, const float* geo) {
  const int cg_n = (dd + kCT - 1) / kCT;
  const int dp = cg_n * kCT;
  const int items = (d.rows / kRT) * cg_n;
  for (int c = 0; c < d.a; ++c) {
    __syncthreads();  // M complete / every thread is done with the previous slice
    const T* Wc = W + (long)c * c1 * dd;
    for (int idx = threadIdx.x; idx < c1 * dp; idx += blockDim.x) {
      const int kk = idx / dp, nn = idx % dp;
      Ws[kk * d.ldw + nn] = nn < dd ? Wc[(long)kk * dd + nn] : from_f<T>(0.f);
    }
    __syncthreads();
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int r0 = (it / cg_n) * kRT, j0 = (it % cg_n) * kCT;
      float t[kRT][kCT];
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int j = 0; j < kCT; ++j) t[i][j] = 0.f;
      for (int kk = 0; kk < c1; ++kk) {
        float w[kCT];
        load4f(Ws + kk * d.ldw + j0, w);
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          const float x = to_f(Ms[(r0 + i) * d.ldm + kk]);
#pragma unroll
          for (int j = 0; j < kCT; ++j) t[i][j] = fmaf(x, w[j], t[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const float at = geo[(r0 + i) * d.gs + c];
        float* y = Ys + (r0 + i) * d.ldy + j0;
#pragma unroll
        for (int j = 0; j < kCT; ++j)
          y[j] = c == 0 ? __fmul_rn(at, t[i][j]) : __fadd_rn(y[j], __fmul_rn(at, t[i][j]));
      }
    }
  }
}

// the gate output of row r, lane j: y_j * sigmoid(y_sel[j]), in the data type
template <typename T>
__device__ __forceinline__ float gate_out(const float* yrow, const int* __restrict__ sel, int j) {
  const float y = round_dt<T>(yrow[j]);
  const float s = round_dt<T>(sigmoid_f(round_dt<T>(yrow[sel[j]])));
  return round_dt<T>(y * s);
}

// the save mode: y rounded to the data type into y [N*K][D], rows of real
// receivers only (reads Ys, as the stage after it does)
template <typename T>
__device__ __forceinline__ void save_y(T* __restrict__ y, int dd, const float* Ys,
                                       const int* rnode, int node0, const Dims& d) {
  for (int w = threadIdx.x; w < d.rows * dd; w += blockDim.x) {
    const int r = w / dd, j = w % dd;
    if (rnode[r] >= 0) y[((long)node0 * d.k + r) * dd + j] = from_f<T>(Ys[r * d.ldy + j]);
  }
}

// TAB: senders through loc/gtab (#8), rows of h; otherwise (#11) slot k of
// receiver i reads row k*N + i of hs [K, N, F]
template <typename T, bool MMA, bool TAB>
__global__ void __launch_bounds__(kThreads, 1)
generic_fwd_kernel(const T* __restrict__ hs, const T* __restrict__ h, const T* __restrict__ geo2,
                       const int* __restrict__ loc, const int* __restrict__ gtab,
                       const T* __restrict__ w1, const int* __restrict__ sel1,
                       const T* __restrict__ w2, const int* __restrict__ sel2,
                       T* __restrict__ out, T* __restrict__ y1, T* __restrict__ y2, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* p = smem_raw;
  float* Ys = reinterpret_cast<float*>(p);
  p += align16(4L * d.rows * d.ldy);
  float* geo = reinterpret_cast<float*>(p);  // [rows][a+2]: attr, d2, mask
  p += align16(4L * d.rows * d.gs);
  T* Ms = reinterpret_cast<T*>(p);  // [rows][ldm] layer input
  p += align16((long)sizeof(T) * d.rows * d.ldm);
  T* Wsl = reinterpret_cast<T*>(p);  // one component's weight slice
  p += align16((long)sizeof(T) * d.wrows * d.ldw);
  int* snd = reinterpret_cast<int*>(p);  // [rows] sender row of hs or -1
  int* rnode = snd + d.rows;             // [rows] receiver node or -1

  const int node0 = blockIdx.x * d.rb;
  const int f = d.f, a = d.a;
  // ---- per-row receiver, sender and geometry
  for (int r = threadIdx.x; r < d.rows; r += blockDim.x) {
    const int node = node0 + r / d.k;
    int s = -1, rn = -1;
    if (r < d.rb * d.k && node < d.n) {
      rn = node;
      const long e = (long)node * d.k + r % d.k;
      if constexpr (TAB) {
        const int l = loc[e];
        if (l < d.u) {
          const int t = gtab[(long)(node / d.tile) * d.u + l];
          s = (t >= 0 && t < d.n) ? t : -1;
        }
      } else {
        s = (r % d.k) * d.n + node;  // the host checks K*N < 2^31
      }
      const T* g = geo2 + e * d.gs;
      for (int q = 0; q < d.gs; ++q) geo[r * d.gs + q] = to_f(g[q]);
    } else {
      for (int q = 0; q < d.gs; ++q) geo[r * d.gs + q] = 0.f;
    }
    snd[r] = s;
    rnode[r] = rn;
  }
  __syncthreads();
  // ---- layer-1 input rows [h_s || h_r || d2], zero-padded to c1p: one warp
  // per row, the first 4 x 32 lanes of both gathers loaded before any store
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int r = warp; r < d.rows; r += nwarps) {
    const int s = snd[r], rn = rnode[r];
    T* mrow = Ms + r * d.ldm;
    float xs[4], xr[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = lane + 32 * q;
      xs[q] = (s >= 0 && j < f) ? to_f(hs[(long)s * f + j]) : 0.f;
      xr[q] = (rn >= 0 && j < f) ? to_f(h[(long)rn * f + j]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = lane + 32 * q;
      if (j < f) {
        mrow[j] = from_f<T>(xs[q]);
        mrow[f + j] = from_f<T>(xr[q]);
      }
    }
    for (int j = 128 + lane; j < f; j += 32) {  // widths past 128
      mrow[j] = from_f<T>(s >= 0 ? to_f(hs[(long)s * f + j]) : 0.f);
      mrow[f + j] = from_f<T>(rn >= 0 ? to_f(h[(long)rn * f + j]) : 0.f);
    }
    for (int j = 2 * f + lane; j < d.c1p; j += 32)
      mrow[j] = from_f<T>(j == 2 * f ? geo[r * d.gs + a] : 0.f);
  }
  // ---- layer 1
  if constexpr (MMA) layer_mma(w1, d.c1a, d.da, d, Ms, Wsl, Ys, geo);
  else layer_fma<T>(w1, d.c1a, d.da, d, Ms, Wsl, Ys, geo);
  __syncthreads();
  if (y1 != nullptr) save_y<T>(y1, d.da, Ys, rnode, node0, d);
  // ---- layer-1 gate -> layer-2 input rows, zero-padded to c1p (a warp per row)
  for (int r = warp; r < d.rows; r += nwarps) {
    const float* yrow = Ys + r * d.ldy;
    T* mrow = Ms + r * d.ldm;
#pragma unroll 2
    for (int j = lane; j < d.c1p; j += 32)
      mrow[j] = from_f<T>(j < d.dk1 ? gate_out<T>(yrow, sel1, j) : 0.f);
  }
  // ---- layer 2
  if constexpr (MMA) layer_mma(w2, d.c1b, d.db, d, Ms, Wsl, Ys, geo);
  else layer_fma<T>(w2, d.c1b, d.db, d, Ms, Wsl, Ys, geo);
  __syncthreads();
  if (y2 != nullptr) save_y<T>(y2, d.db, Ys, rnode, node0, d);
  // ---- layer-2 gate, mask, fp32 sum over K in slot order (a warp per receiver)
  for (int i = warp; i < d.rb && node0 + i < d.n; i += nwarps) {
    for (int j = lane; j < d.dk2; j += 32) {
      float acc = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < d.k; ++kk) {
        const int r = i * d.k + kk;
        const float m = gate_out<T>(Ys + r * d.ldy, sel2, j);
        acc += round_dt<T>(m * geo[r * d.gs + a + 1]);
      }
      out[(long)(node0 + i) * d.dk2 + j] = from_f<T>(acc);
    }
  }
}

// bytes of shared memory, or -1 for shapes the kernel does not take (bf16
// widths past the tensor-core engine's limits among them)
long smem_for(int dtype, int k, int a, int c1a, int da, int c1b, int db) {
  if (k < 1 || a < 1 || c1a < 1 || c1b < 1 || da < 1 || db < 1) return -1;
  if (dtype == 1 && (c1a > 16 * kMaxKS || c1b > 16 * kMaxKS || da > 8 * kMaxNT ||
                     db > 8 * kMaxNT))
    return -1;
  const Dims d = make_dims(dtype == 1, 1, 0, k, a, 1, 1, c1a, da, 0, c1b, db, 0);
  if (d.rb < 1) return -1;
  if (dtype == 0) return smem_bytes<float>(d);
  if (dtype == 1) return smem_bytes<__nv_bfloat16>(d);
  return -1;
}

template <typename T, bool MMA, bool TAB>
int launch(const Dims& d, const void* hs, const void* h, const void* geo2, const int* loc,
           const int* gtab, const void* w1, const int* sel1, const void* w2, const int* sel2,
           void* out, void* y1, void* y2, cudaStream_t stream) {
  const long smem = smem_bytes<T>(d);
  auto kern = generic_fwd_kernel<T, MMA, TAB>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (d.n + d.rb - 1) / d.rb;
  if (grid < 1) return 0;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(hs), static_cast<const T*>(h), static_cast<const T*>(geo2), loc, gtab,
      static_cast<const T*>(w1), sel1, static_cast<const T*>(w2), sel2, static_cast<T*>(out),
      static_cast<T*>(y1), static_cast<T*>(y2), d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs (bytes), or -1 for shapes the kernel does not
// take; the wrapper checks it against the card's limit before launching.
long fused_message_generic_tab_fwd_smem_bytes(int dtype, int k, int a, int c1a, int da, int c1b,
                                              int db) {
  return smem_for(dtype, k, a, c1a, da, c1b, db);
}

// dtype: 0 = float32 (the FMA engine, weights [A*C1][D]), 1 = bfloat16 (the
// tensor-core engine, weights [A][D rounded up to 8][C1 rounded up to 16],
// transposed and zero-padded).  y1, y2: null, or the save mode's [N*K, D_l]
// outputs.  Returns cudaGetLastError() after the launch (0 on success).
int fused_message_generic_tab_fwd(int dtype, const void* h, const void* geo2, const void* loc,
                                  const void* gtab, const void* w1, const void* sel1,
                                  const void* w2, const void* sel2, void* out, void* y1,
                                  void* y2, int n, int f,
                                  int k, int a, int tile, int u, int c1a, int da, int dk1,
                                  int c1b, int db, int dk2, void* stream) {
  if (smem_for(dtype, k, a, c1a, da, c1b, db) < 0) return (int)cudaErrorInvalidValue;
  const int* loc_i = static_cast<const int*>(loc);
  const int* gtab_i = static_cast<const int*>(gtab);
  const int* s1 = static_cast<const int*>(sel1);
  const int* s2 = static_cast<const int*>(sel2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Dims d = make_dims(false, n, f, k, a, tile, u, c1a, da, dk1, c1b, db, dk2);
    return launch<float, false, true>(d, h, h, geo2, loc_i, gtab_i, w1, s1, w2, s2, out, y1, y2,
                                      st);
  }
  if (dtype == 1) {
    const Dims d = make_dims(true, n, f, k, a, tile, u, c1a, da, dk1, c1b, db, dk2);
    return launch<__nv_bfloat16, true, true>(d, h, h, geo2, loc_i, gtab_i, w1, s1, w2, s2, out,
                                             y1, y2, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The untabled kernel (#11): hs [K, N, F] slot-major sender rows, h [N, F] the
// receivers; otherwise as above.  Returns cudaGetLastError() after the launch.
int fused_message_generic_fwd(int dtype, const void* hs, const void* h, const void* geo2,
                              const void* w1, const void* sel1, const void* w2,
                              const void* sel2, void* out, void* y1, void* y2, int n, int f,
                              int k, int a, int c1a, int da, int dk1, int c1b, int db, int dk2,
                              void* stream) {
  if (smem_for(dtype, k, a, c1a, da, c1b, db) < 0) return (int)cudaErrorInvalidValue;
  if ((long)k * n > 2147483647L) return (int)cudaErrorInvalidValue;
  const int* s1 = static_cast<const int*>(sel1);
  const int* s2 = static_cast<const int*>(sel2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Dims d = make_dims(false, n, f, k, a, 1, 0, c1a, da, dk1, c1b, db, dk2);
    return launch<float, false, false>(d, hs, h, geo2, nullptr, nullptr, w1, s1, w2, s2, out,
                                       y1, y2, st);
  }
  if (dtype == 1) {
    const Dims d = make_dims(true, n, f, k, a, 1, 0, c1a, da, dk1, c1b, db, dk2);
    return launch<__nv_bfloat16, true, false>(d, hs, h, geo2, nullptr, nullptr, w1, s1, w2, s2,
                                              out, y1, y2, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
