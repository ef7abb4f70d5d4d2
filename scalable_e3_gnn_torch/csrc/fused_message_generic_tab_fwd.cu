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
//   m_l+1  = y_l[:, :dk_l] * sigmoid(y_l)[:, sel_l]                   (l < L)
//   agg[i] = sum_k mask[i,k] * m_L
//
// for any number L >= 1 of message layers (SEGNNLayer's num_message_layers;
// the per-layer widths come from the wrapper's layer table, generic_mma.cuh
// LayerField; the layer count is a runtime value)
//
// (the gate as written is silu's selection form; under another activation,
// GENERIC_ACT of gate_act.cuh, the scalar lanes, sel_l[j] == j, take
// rnd(act(y_l[:, j])) instead: JAX's concat-form gate, Gate.__call__)
//
// with the sender row x_s = h[gtab[i / tile, loc[i,k]]] (tabled, #8; loc == U
// means no sender: a zero row) or x_s = hs[k, i] (untabled, #11; every slot is
// read, masked slots carry some real row and their mask zeroes the message).
//
// With y given (the save mode, for the residual backward) the kernel also
// writes each layer's pre-gate y_l, rounded to the data type, one row per
// slot: y_l[i*K + k] (node-major [N*K, D_l], in both modes, the layers one
// after the other in y; the TPU kernel #11 writes [K, N, D_l], a layout only
// its own backward reads).
//
// W_l [A*C1_l, D_l] are the CG-folded weights with their columns permuted to
// scalars || gated || gates (fp32: the layers' flat weights one after the
// other), sel_l [dk_l] the sigmoid lane of each gate output (all layers' in one array)
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
// streams the weights through it; the fp32 sum over c stays in registers
// (bf16) or shared memory (fp32).
// - bf16 (any width whose rows fit a block's shared memory): 4 warps x 16
//   rows = 64 rows, two blocks an SM where the shared memory allows (one
//   block's gathers and barriers overlap the other's products), on the
//   engine of csrc/generic_mma.cuh,
//   shared with the backward: mma.sync m16n8k16 (bf16 in, fp32 accumulate) over only the
//   16x8 tiles of W_l[c] that hold a structural nonzero (31% of them at the
//   lmax=2 config, 14% at A = 36), packed by the wrapper in the order the
//   warps take them and streamed by cp.async.bulk into a 4-stage ring with
//   mbarriers (no block barrier per component; layer 1's first chunks load
//   while the rows are gathered, each next layer's while the gate runs).
//   A layer's D is walked in column blocks of 128 (generic_mma.cuh), and the
//   gate in blocks of 192 columns, so no register array grows with the
//   width (past D = 128 or C1 = 192 the ring is two stages, one block an
//   SM).  Skipped
//   tiles add exactly 0, so y is bitwise the dense product's, and the
//   backward's replay gives bitwise the same y.
// - fp32 (the check path): 64 rows, each thread a 4 x 4 fp32 FMA tile per work
//   item, W_l[c] [C1][D] in shared memory, the sum over c in a shared
//   [rows][D] fp32 buffer.  Where the slice does not fit beside the rows the
//   weights are read from global memory (L2), and where the rows do not fit
//   either a block takes 32 or 16 rows (at least K): the same sums.
//
// Work.  The dense GEMMs would run 2 A (C1_0 D_0 + C1_1 D_1) = 526,824 flops
// per valid slot at the lmax=2 config (A=9, C1 = 181 / 90, D = 108); the
// function needs 2 x 30,240 (the folded nonzeros), and the listed tiles hold
// 711 of 2,268 tiles: 165,888 flops.  The untabled kernel's bytes (hs once,
// K times the size of h) bound it at config 5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gate_act.cuh"
#include "generic_mma.cuh"

// GENERIC_FWD_CLOCKS (a profiling build of generic_ab.py, never the
// package's library): thread 0 of each block adds the cycles of each phase
// to phase_cycles[], read back by generic_fwd_phase_cycles.
#ifdef GENERIC_FWD_CLOCKS
__device__ unsigned long long phase_cycles[8];
#define PHASE(i)                                                         \
  do {                                                                   \
    __syncthreads();                                                     \
    if (threadIdx.x == 0) {                                              \
      const long long now = clock64();                                   \
      atomicAdd(&phase_cycles[i], (unsigned long long)(now - phase_t0)); \
      phase_t0 = now;                                                    \
    }                                                                    \
  } while (0)
#else
#define PHASE(i) \
  do {           \
  } while (0)
#endif

namespace {

constexpr int kThreadsMma = 128;  // bf16: 4 warps x 16 rows, two blocks an SM
constexpr int kThreadsFma = 256;
constexpr int kRowsMma = 64;
constexpr int kRowsFma = 64;
constexpr int kGateCols = 192;  // mma engine: gate columns a warp's lanes hold per block
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

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline long align16(long bytes) { return (bytes + 15) / 16 * 16; }

struct Dims {
  int n, f, k, a, tile, u;
  int nl;              // message layers
  int dk_last;         // the output width (the last layer's gate outputs)
  int rows, rb;  // slot rows per block, receivers per block (rb * k <= rows)
  int c1p, ldm;  // padded layer-input width, its row stride
  int dp, ldw;   // padded layer-output width, the weight slice's row stride
  int ldy, gs;   // y row stride, geometry row width (a + 2)
  int wrows;     // rows of the weight slice in shared memory (fp32; 0: read from global)
  int stages;    // bf16: the depth of the engine's ring
  int nmasks;    // bf16: the plan's forward masks of every layer (blocks x A x C1/16 each)
};

// w3: the layers' (C1, D, dk), nl of them (host memory)
__host__ __device__ inline Dims make_dims(bool mma, int n, int f, int k, int a, int tile, int u,
                                          int nl, const int* w3) {
  Dims d;
  d.n = n; d.f = f; d.k = k; d.a = a; d.tile = tile; d.u = u;
  d.nl = nl;
  int c1max = 0, dmax = 0, ks = 0;
  for (int l = 0; l < nl; ++l) {
    c1max = w3[3 * l] > c1max ? w3[3 * l] : c1max;
    dmax = w3[3 * l + 1] > dmax ? w3[3 * l + 1] : dmax;
    ks += (w3[3 * l] + 15) / 16 * gmma::fwd_blocks(w3[3 * l + 1]);
  }
  d.dk_last = nl > 0 ? w3[3 * nl - 1] : 0;
  d.rows = mma ? kRowsMma : kRowsFma;
  d.rb = k > 0 ? d.rows / k : 0;
  if (mma) {
    d.c1p = round_up(c1max, 16);
    d.ldm = d.c1p + 8;  // 32-bit words per row = 4 mod 8: conflict-free fragment loads
    d.dp = round_up(dmax, 8);
    d.ldw = 0;          // the weights stream through the engine's ring
    d.wrows = 0;
  } else {
    d.c1p = round_up(c1max, 4);
    d.ldm = d.c1p;
    d.dp = round_up(dmax, 4);
    d.ldw = d.dp;       // [c1max][ldw]
    d.wrows = c1max;
  }
  d.ldy = d.dp;
  d.gs = a + 2;
  d.stages = 0;
  d.nmasks = a * ks;
  if (mma)  // as deep a ring as leaves two blocks an SM
    d.stages = gmma::ring_stages(align16(2L * d.rows * d.ldy) + align16(4L * d.rows * d.gs) +
                                 align16(2L * d.rows * d.ldm) + align16(8L * d.rows) +
                                 gmma::table_bytes(d.nmasks));
  return d;
}

// Ys (in the data type: bf16 holds the rounded y, fp32 the sums), geometry,
// M, weights (the fp32 slice, or the bf16 engine's ring and the plan's
// tables), senders and receivers
template <typename T>
__host__ __device__ inline long smem_bytes(const Dims& d) {
  return align16((long)sizeof(T) * d.rows * d.ldy) + align16(4L * d.rows * d.gs) +
         align16((long)sizeof(T) * d.rows * d.ldm) +
         (sizeof(T) == 2 ? gmma::ring_bytes(d.stages) + gmma::table_bytes(d.nmasks)
                         : align16((long)sizeof(T) * d.wrows * d.ldw)) +
         align16(8L * d.rows);
}

// y = sum_c attr_c * (M @ W[c]) on the engine of generic_mma.cuh over the
// layer's weight stream, one column block of D at a time, rounded to bf16
// into Ys (columns up to D rounded to 8).  Starts with a block barrier (M
// complete).
__device__ void layer_mma(gmma::Ring& ring, int stream, const uint32_t* masks, int c1, int dd,
                          const Dims& d, const __nv_bfloat16* Ms, __nv_bfloat16* Ys,
                          const float* geo) {
  constexpr int NT = gmma::kBlockNT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const int nt_n = (dd + 7) / 8, ks_n = (c1 + 15) / 16, nb = gmma::fwd_blocks(dd);
  __syncthreads();
  gmma::Cursor cur = gmma::open(ring, stream);
  for (int b = 0; b < nb; ++b) {
    float acc[NT][4];
    gmma::gemm_fwd<NT>(ring, cur, masks + b * d.a * ks_n, d.a, ks_n, Ms, d.ldm, geo, d.gs, acc);
    if (b + 1 == nb) gmma::close(ring, cur, lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (b * NT + nt < nt_n) {
        const int col = (b * NT + nt) * 8 + t4 * 2;
        *reinterpret_cast<__nv_bfloat162*>(Ys + (r0 + g) * d.ldy + col) =
            __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<__nv_bfloat162*>(Ys + (r0 + g + 8) * d.ldy + col) =
            __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
      }
    }
  }
}

// y = sum_c attr_c * (M @ W[c]) on the FMA units; leaves the fp32 sum in Ys
// (the reader rounds it).  W[c] is staged in shared memory (Ws) where it fits
// (d.wrows > 0), else read from global memory.  Starts with a block barrier
// (M complete).
template <typename T>
__device__ void layer_fma(const T* __restrict__ W, int c1, int dd, const Dims& d,
                          const T* Ms, T* Ws, float* Ys, const float* geo) {
  const int cg_n = (dd + kCT - 1) / kCT;
  const int dp = cg_n * kCT;
  const int items = (d.rows / kRT) * cg_n;
  const bool staged = d.wrows > 0;
  for (int c = 0; c < d.a; ++c) {
    __syncthreads();  // M complete / every thread is done with the previous slice
    const T* Wc = W + (long)c * c1 * dd;
    for (int idx = threadIdx.x; staged && idx < c1 * dp; idx += blockDim.x) {
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
        if (staged) {
          load4f(Ws + kk * d.ldw + j0, w);
        } else {
#pragma unroll
          for (int j = 0; j < kCT; ++j) w[j] = j0 + j < dd ? to_f(Wc[(long)kk * dd + j0 + j]) : 0.f;
        }
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

// the gate output of a row, lane j: y_j * sigmoid(y_s), s = sel[j] (the
// lane's selection, held in a register), in the data type; under another
// activation than silu a scalar lane (s == j) is act(y_j) in fp32, rounded
template <typename T, int ACT = gact::kAct>
__device__ __forceinline__ float gate_out(const T* yrow, int s, int j) {
  if constexpr (ACT != gact::kSilu) {
    if (s == j) return round_dt<T>(gact::act_f<ACT>(round_dt<T>(to_f(yrow[j]))));
  }
  const float y = round_dt<T>(to_f(yrow[j]));
  const float sg = round_dt<T>(sigmoid_f(round_dt<T>(to_f(yrow[s]))));
  return round_dt<T>(y * sg);
}

// the save mode: y rounded to the data type into y [N*K][D], rows of real
// receivers only (reads Ys, as the stage after it does)
template <typename T>
__device__ __forceinline__ void save_y(T* __restrict__ y, int dd, const T* Ys,
                                       const int* rnode, int node0, const Dims& d) {
  for (int w = threadIdx.x; w < d.rows * dd; w += blockDim.x) {
    const int r = w / dd, j = w % dd;
    if (rnode[r] >= 0) y[((long)node0 * d.k + r) * dd + j] = Ys[r * d.ldy + j];
  }
}

// TAB: senders through loc/gtab (#8), rows of h; otherwise (#11) slot k of
// receiver i reads row k*N + i of hs [K, N, F].  w (fp32): the layers' flat
// weights; sel: the layers' selections; layers: the wrapper's layer table;
// y: null, or the save mode's ys, the layers' [N*K, D_l] one after the other.
template <typename T, bool MMA, bool TAB>
__global__ void __launch_bounds__(MMA ? kThreadsMma : kThreadsFma, MMA ? 2 : 1)
generic_fwd_kernel(const T* __restrict__ hs, const T* __restrict__ h, const T* __restrict__ geo2,
                       const int* __restrict__ loc, const int* __restrict__ gtab,
                       const T* __restrict__ w, const int* __restrict__ sel,
                       const int* __restrict__ layers, T* __restrict__ out, T* __restrict__ y,
                       const __nv_bfloat16* __restrict__ wpk, const uint32_t* __restrict__ masks,
                       const int* __restrict__ chunks, int nstreams, int nq, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* p = smem_raw;
  T* Ys = reinterpret_cast<T*>(p);  // [rows][ldy] y (bf16: rounded; fp32: the sums)
  p += align16((long)sizeof(T) * d.rows * d.ldy);
  float* geo = reinterpret_cast<float*>(p);  // [rows][a+2]: attr, d2, mask
  p += align16(4L * d.rows * d.gs);
  T* Ms = reinterpret_cast<T*>(p);  // [rows][ldm] layer input
  p += align16((long)sizeof(T) * d.rows * d.ldm);
  T* Wsl = reinterpret_cast<T*>(p);  // fp32: one component's weight slice
  gmma::Ring ring;                   // bf16: the engine's ring of weight tiles
  unsigned char* ring_p = p;
  uint32_t* masks_s = nullptr;       // bf16: the plan's masks, then its chunk table
  if constexpr (MMA) {
    p += gmma::ring_bytes(d.stages);
    masks_s = reinterpret_cast<uint32_t*>(p);
    p += gmma::table_bytes(d.nmasks);
  } else {
    p += align16((long)sizeof(T) * d.wrows * d.ldw);
  }
  int* snd = reinterpret_cast<int*>(p);  // [rows] sender row of hs or -1
  int* rnode = snd + d.rows;             // [rows] receiver node or -1

  const int node0 = blockIdx.x * d.rb;
  const int f = d.f, a = d.a;
#ifdef GENERIC_FWD_CLOCKS
  long long phase_t0 = clock64();
#endif
  if constexpr (MMA) {
    gmma::load_tables(masks, d.nmasks, chunks + nstreams + 1, nq, masks_s);
    __syncthreads();
    ring.setup(ring_p, d.stages, wpk, reinterpret_cast<const int*>(masks_s + d.nmasks), chunks,
               nq);
    ring.start(blockDim.x >> 5);  // layer 1's first chunks load during the gather
  }
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
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int w = w0 + u * blockDim.x;
        v[u] = w < nreal ? to_f(g[w]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (w0 + u * blockDim.x < d.rows * d.gs) geo[w0 + u * blockDim.x] = v[u];
    }
  }
  __syncthreads();
  // ---- layer-1 input rows [h_s || h_r || d2], zero-padded to c1p: one warp
  // per row; bf16 rows of even width by 4-byte cp.async, every row's words
  // in flight at once, else the first 4 x 32 lanes of both gathers loaded
  // before any store
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const bool words = sizeof(T) == 2 && f % 2 == 0;
  for (int r = warp; r < d.rows; r += nwarps) {
    const int s = snd[r], rn = rnode[r];
    T* mrow = Ms + r * d.ldm;
    if (words) {
      if constexpr (sizeof(T) == 2) {
        gmma::gather_row(mrow, s >= 0 ? hs + (long)s * f : nullptr, f, lane);
        gmma::gather_row(mrow + f, rn >= 0 ? h + (long)rn * f : nullptr, f, lane);
      }
    } else {
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
    }
    for (int j = 2 * f + lane; j < d.c1p; j += 32)
      mrow[j] = from_f<T>(j == 2 * f ? geo[r * d.gs + a] : 0.f);
  }
  if (words) gmma::cp_async_wait_all();  // layer 1 starts with a block barrier
  PHASE(1);  // rows, geometry and the gather
  const long nk = (long)d.n * d.k;  // slot rows of one layer's saved y
  for (int l = 0; l < d.nl; ++l) {
    using gmma::layer_field;
    const int c1 = layer_field(layers, l, gmma::kC1), dd = layer_field(layers, l, gmma::kD);
    const int dk = layer_field(layers, l, gmma::kDk);
    const int* sl = sel + layer_field(layers, l, gmma::kSelOff);
    T* yl = y == nullptr ? nullptr : y + nk * layer_field(layers, l, gmma::kYOff);
    // ---- layer l
    if constexpr (MMA)
      layer_mma(ring, l, masks_s + layer_field(layers, l, gmma::kMaskFwd), c1, dd, d, Ms, Ys, geo);
    else layer_fma<T>(w + layer_field(layers, l, gmma::kWOff), c1, dd, d, Ms, Wsl, Ys, geo);
    __syncthreads();
    if (l + 1 == d.nl) break;
    PHASE(2);
    if (yl != nullptr) save_y<T>(yl, dd, Ys, rnode, node0, d);
    // ---- layer-l gate -> layer-(l+1) input rows, zero-padded to c1p (a warp
    // per row; bf16: each lane's selections in registers, two rows at a time)
    if constexpr (MMA) {
      constexpr int kLanes = kGateCols / 32;  // columns per lane in a block of the gate
      for (int j0 = 0; j0 < d.c1p; j0 += kGateCols) {
        int s1[kLanes];
#pragma unroll
        for (int q = 0; q < kLanes; ++q) {
          const int j = j0 + lane + 32 * q;
          s1[q] = j < dk ? sl[j] : 0;
        }
#pragma unroll 2
        for (int r = warp; r < d.rows; r += nwarps) {
          const T* yrow = Ys + r * d.ldy;
          T* mrow = Ms + r * d.ldm;
#pragma unroll
          for (int q = 0; q < kLanes; ++q) {
            const int j = j0 + lane + 32 * q;
            if (j < d.c1p) mrow[j] = from_f<T>(j < dk ? gate_out<T>(yrow, s1[q], j) : 0.f);
          }
        }
      }
    } else {
      for (int r = warp; r < d.rows; r += nwarps) {
        const T* yrow = Ys + r * d.ldy;
        T* mrow = Ms + r * d.ldm;
        for (int j = lane; j < d.c1p; j += 32)
          mrow[j] = from_f<T>(j < dk ? gate_out<T>(yrow, sl[j], j) : 0.f);
      }
    }
    PHASE(3);  // save, gate
  }
  PHASE(4);  // the last layer
  {
    const int last = d.nl - 1;
    const int dd = gmma::layer_field(layers, last, gmma::kD);
    const int* sl = sel + gmma::layer_field(layers, last, gmma::kSelOff);
    if (y != nullptr)
      save_y<T>(y + nk * gmma::layer_field(layers, last, gmma::kYOff), dd, Ys, rnode, node0, d);
    // ---- the last gate, mask, fp32 sum over K in slot order (a warp per receiver)
    for (int i = warp; i < d.rb && node0 + i < d.n; i += nwarps) {
      for (int j = lane; j < d.dk_last; j += 32) {
        const int s2 = sl[j];
        float acc = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < d.k; ++kk) {
          const int r = i * d.k + kk;
          const float m = gate_out<T>(Ys + r * d.ldy, s2, j);
          acc += round_dt<T>(m * geo[r * d.gs + a + 1]);
        }
        out[(long)(node0 + i) * d.dk_last + j] = from_f<T>(acc);
      }
    }
  }
  PHASE(5);  // gate, mask, K-sum, store
}

// fp32: the weight slice in shared memory where it fits beside the rows,
// else read from global memory; then the rows halved (down to K) until the
// block fits.  Past that the block needs more than the card has, and the
// wrapper raises.
Dims fit_fma(Dims d) {
  if (smem_bytes<float>(d) > gmma::kMaxSmem) d.wrows = d.ldw = 0;
  while (smem_bytes<float>(d) > gmma::kMaxSmem && d.rows / 2 >= d.k) {
    d.rows /= 2;
    d.rb = d.rows / d.k;
  }
  return d;
}

Dims dims_for(int dtype, int n, int f, int k, int a, int tile, int u, int nl, const int* w3) {
  const Dims d = make_dims(dtype == 1, n, f, k, a, tile, u, nl, w3);
  return dtype == 1 ? d : fit_fma(d);
}

// bytes of shared memory (more than the card has for widths past what fits),
// or -1 for shapes the kernel does not take
long smem_for(int dtype, int k, int a, int nl, const int* w3) {
  if (k < 1 || a < 1 || nl < 1 || w3 == nullptr) return -1;
  for (int l = 0; l < nl; ++l) {
    const int c1 = w3[3 * l], dd = w3[3 * l + 1];
    if (c1 < 1 || dd < 1) return -1;
  }
  if (dtype != 0 && dtype != 1) return -1;
  const Dims d = dims_for(dtype, 1, 0, k, a, 1, 1, nl, w3);
  if (d.rb < 1) return -1;
  if (dtype == 0) return smem_bytes<float>(d);
  if (dtype == 1) return smem_bytes<__nv_bfloat16>(d);
  return -1;
}

// the layers' widths chain (C1_0 = 2F+1, C1_l+1 = dk_l <= D_l): the kernel
// gates layer l's output into layer l+1's input rows
bool widths_ok(int f, int nl, const int* w3) {
  if (w3[0] != 2 * f + 1) return false;
  for (int l = 0; l < nl; ++l) {
    if (w3[3 * l + 2] < 1 || w3[3 * l + 2] > w3[3 * l + 1]) return false;
    if (l + 1 < nl && w3[3 * (l + 1)] != w3[3 * l + 2]) return false;
  }
  return true;
}

// the weight tiles of every layer (bf16): the packed streams, the plan's
// masks, the streams' first chunks then the chunk table, the streams and
// chunks
struct Packed {
  const void* wpk;
  const void* masks;
  const void* chunks;
  int nstreams, nq;
};

template <typename T, bool MMA, bool TAB>
int launch(const Dims& d, const void* hs, const void* h, const void* geo2, const int* loc,
           const int* gtab, const void* w, const int* sel, const int* layers, void* out, void* y,
           const Packed& pk, cudaStream_t stream) {
  const long smem = smem_bytes<T>(d);
  auto kern = generic_fwd_kernel<T, MMA, TAB>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (d.n + d.rb - 1) / d.rb;
  if (grid < 1) return 0;
  kern<<<grid, MMA ? kThreadsMma : kThreadsFma, smem, stream>>>(
      static_cast<const T*>(hs), static_cast<const T*>(h), static_cast<const T*>(geo2), loc, gtab,
      static_cast<const T*>(w), sel, layers, static_cast<T*>(out), static_cast<T*>(y),
      static_cast<const __nv_bfloat16*>(pk.wpk), static_cast<const uint32_t*>(pk.masks),
      static_cast<const int*>(pk.chunks), pk.nstreams, pk.nq, d);
  return (int)cudaGetLastError();
}

// bf16: one forward stream per layer; fp32: the flat weights
// (a chunk holds at least one row: no more chunks than masks)
bool packed_ok(int dtype, const Packed& pk, const Dims& d, const void* w) {
  if (dtype != 1) return w != nullptr;
  return pk.wpk != nullptr && pk.masks != nullptr && pk.chunks != nullptr &&
         pk.nstreams == d.nl && pk.nq >= 0 && pk.nq <= d.nmasks;
}

}  // namespace

extern "C" {

// The shared memory one block may take (bytes): the limit the fp32 engine's
// dims fit into and the wrapper checks smem_bytes against.
long fused_message_generic_tab_fwd_max_smem() { return gmma::kMaxSmem; }

// Shared memory one block needs (bytes), or -1 for shapes the kernel does not
// take; widths: the nl layers' (C1, D, dk) in host memory.  The wrapper checks
// it against max_smem before launching (past it the widths do not fit a
// block).
long fused_message_generic_tab_fwd_smem_bytes(int dtype, int k, int a, int nl,
                                              const int* widths) {
  return smem_for(dtype, k, a, nl, widths);
}

// dtype: 0 = float32 (the FMA engine, w the layers' flat weights [A*C1][D]
// one after the other), 1 = bfloat16 (the tensor-core engine of
// generic_mma.cuh: wpk the listed 16x8 tiles of every layer's forward GEMM in
// fragment order, one stream per layer, in nq chunks; chunks the streams'
// first chunks [nl + 1] then every chunk's first tile [nq + 1]; masks the
// plan's bit masks, [fwd_blocks(D)][A][C1/16] per layer (kernels/tile_plan.py);
// w unused).
// sel: the layers' selections one after the other; layers: the layer table
// (device memory, generic_mma.cuh LayerField); widths: the layers' (C1, D,
// dk) (host memory).  y: null, or the save mode's [N*K, D_l] outputs, the
// layers one after the other.  Returns cudaGetLastError() after the launch
// (0 on success).
int fused_message_generic_tab_fwd(int dtype, const void* h, const void* geo2, const void* loc,
                                  const void* gtab, const void* w, const void* sel,
                                  const void* layers, void* out, void* y, const void* wpk,
                                  const void* masks, const void* chunks, int n, int f, int k,
                                  int a, int tile, int u, int nl, const int* widths, int nq,
                                  void* stream) {
  if (smem_for(dtype, k, a, nl, widths) < 0 || !widths_ok(f, nl, widths))
    return (int)cudaErrorInvalidValue;
  if (sel == nullptr || layers == nullptr) return (int)cudaErrorInvalidValue;
  const Packed pk{wpk, masks, chunks, nl, nq};
  const int* loc_i = static_cast<const int*>(loc);
  const int* gtab_i = static_cast<const int*>(gtab);
  const int* s = static_cast<const int*>(sel);
  const int* lt = static_cast<const int*>(layers);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d = dims_for(dtype, n, f, k, a, tile, u, nl, widths);
  if (!packed_ok(dtype, pk, d, w)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, false, true>(d, h, h, geo2, loc_i, gtab_i, w, s, lt, out, y, pk, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, true, true>(d, h, h, geo2, loc_i, gtab_i, w, s, lt, out, y, pk,
                                             st);
  return (int)cudaErrorInvalidValue;
}

// The untabled kernel (#11): hs [K, N, F] slot-major sender rows, h [N, F] the
// receivers; otherwise as above.  Returns cudaGetLastError() after the launch.
int fused_message_generic_fwd(int dtype, const void* hs, const void* h, const void* geo2,
                              const void* w, const void* sel, const void* layers, void* out,
                              void* y, const void* wpk, const void* masks, const void* chunks,
                              int n, int f, int k, int a, int nl, const int* widths, int nq,
                              void* stream) {
  if (smem_for(dtype, k, a, nl, widths) < 0 || !widths_ok(f, nl, widths))
    return (int)cudaErrorInvalidValue;
  if (sel == nullptr || layers == nullptr) return (int)cudaErrorInvalidValue;
  if ((long)k * n > 2147483647L) return (int)cudaErrorInvalidValue;
  const Packed pk{wpk, masks, chunks, nl, nq};
  const int* s = static_cast<const int*>(sel);
  const int* lt = static_cast<const int*>(layers);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d = dims_for(dtype, n, f, k, a, 1, 0, nl, widths);
  if (!packed_ok(dtype, pk, d, w)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, false, false>(d, hs, h, geo2, nullptr, nullptr, w, s, lt, out, y, pk,
                                       st);
  if (dtype == 1)
    return launch<__nv_bfloat16, true, false>(d, hs, h, geo2, nullptr, nullptr, w, s, lt, out,
                                              y, pk, st);
  return (int)cudaErrorInvalidValue;
}

#ifdef GENERIC_FWD_CLOCKS
// the phases' cycles summed over every block since the last call (then 0)
int generic_fwd_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
}
#endif

}  // extern "C"
