// The generic message kernels' tensor-core engine (sm_90a), shared by
// fused_message_generic_tab_fwd.cu (#8, #11) and fused_message_generic_tab_bwd.cu
// (#9, #10, #12, #13, #14): y = sum_c attr_c * (M @ W[c]) and the two dm
// products, each over only the nonzero 16x8 tiles of the CG-folded weights.
//
// The weights.  The wrapper (kernels/tile_plan.py) lists, per layer and
// attribute component c, the 16x8 B tiles of W[c] that hold any structural
// nonzero, and packs them into streams: one contiguous run per GEMM, in the
// order the engine walks them (column block, then c, then the outer tile
// index, then the inner), each tile 128 bf16 in fragment order (lane L's b0,
// b1 at 8 L bytes: one 8-byte shared load per mma).  A mask per (block, c,
// outer) holds a bit per inner tile of the block.  An all-zero k-step adds
// exactly 0 to an fp32 accumulator, so every output is bitwise that of the
// dense per-component product (the tensor cores' accumulation of the listed
// tiles runs in the same k-order).
//
// The ring.  The streams a kernel consumes (its GEMMs in order: one or two
// per message layer, any number of layers) are one sequence of chunks of at
// most kChunk tiles (16 KB).  A chunk holds whole rows (a row: the tiles of
// one (block, c, outer) mask) and never spans two streams; the wrapper lays the
// chunks out and passes, in one device array, each stream's first chunk
// (q_base [S + 1], the last entry the chunk count Q) and then every chunk's
// first tile (chunks [Q + 1], offsets at src).  Thread 0 copies chunks by
// cp.async.bulk into a ring of stages (as many as leave two blocks an SM,
// 2 to 8), each with a full mbarrier
// (the copy's bytes) and an empty one (a lane of every warp arrives when its
// warp is done with the chunk); a warp checks at the start of each row
// whether the row lies past its chunk and then waits for the next, so no
// block barrier is spent per component and the check is per row, not per
// tile.  Thread 0 refills a stage as soon as every warp has released it,
// which also starts the next GEMM's first chunks while the block gathers or
// runs a gate, and the first chunks at kernel start while the rows are
// gathered.
//
// Each warp owns 16 slot rows and one column block at a time; the component
// sum stays in registers (t per component, acc over components: the TPU
// kernel's rounding, each product in fp32, scaled by attr_c in fp32, summed
// over c in fp32).
//
// Column blocks.  A GEMM's output columns are walked in blocks of at most
// kBlockNT (forward: 128 columns of D) or kBlockCT (dm: 192 columns of C1)
// n-tiles, so each register array keeps one size at any width; the masks and
// the stream hold the blocks one after the other (block, then c, then the
// outer tile index, then the inner), and each block re-reads the warp's
// input rows from shared memory.  An output element is summed over the same
// k-steps in the same order in any block, so the blocks change no bit; at
// D <= 128 and C1 <= 192 there is one block and the walk is the unblocked
// one.
//
// The fragment, ldmatrix and cp.async helpers below also serve the lmax=1
// engine (lmax1_mma.cuh).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace gmma {

typedef __nv_bfloat16 bf16;

constexpr int kMinStages = 2, kMaxStages = 8;
constexpr int kBlockNT = 16;                  // forward GEMM: n-tiles per column block
constexpr int kBlockCT = 24;                  // dm GEMM: n-tiles per column block
// shared memory one block may take (227 KB, the H100's opt-in limit)
constexpr long kMaxSmem = 232448;
constexpr int kChunk = 64;                    // tiles per chunk
constexpr int kTileBytes = 256;               // 16 x 8 bf16
constexpr int kStageBytes = kChunk * kTileBytes;
// shared memory a block may take so that two blocks share an SM (228 KB an
// SM, 1 KB of it reserved per block)
constexpr long kTwoBlockSmem = 115712;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 at p scaled by s, each product rounded to bf16, packed (low = p[0])
__device__ __forceinline__ uint32_t scale2(const bf16* p, float s) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  __nv_bfloat162 o = __floats2bfloat162_rn(__fmul_rn(v.x, s), __fmul_rn(v.y, s));
  return *reinterpret_cast<uint32_t*>(&o);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from global to shared memory, asynchronously (the row gathers:
// every word of a block's rows in flight at once)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
// 16 bytes from global to shared memory, asynchronously (L2 only); a
// group of them is closed by cp_async_commit and awaited by cp_async_wait<N>
// (at most N groups still in flight)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ldmatrix: four 8x8 b16 matrices from the rows that lanes 0-7, 8-15, 16-23
// and 24-31 address (16 bytes each), as mma fragments: r[i] holds row
// lane / 4, elements 2 (lane % 4) and +1 of matrix i; .trans delivers the
// transposed matrices (column lane / 4, rows 2 (lane % 4) and +1)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
// two transposed matrices, from the rows lanes 0-7 and 8-15 address
__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(smem_addr(p)));
}

// a feature row of f bf16 (f even: 4-byte aligned) from global src, or
// zeros (src null), into shared dst by the 32 lanes of a warp
__device__ __forceinline__ void gather_row(bf16* dst, const bf16* src, int f, int lane) {
  for (int q = lane; q < f / 2; q += 32) {
    if (src != nullptr) cp_async4(dst + 2 * q, src + 2 * q);
    else *reinterpret_cast<uint32_t*>(dst + 2 * q) = 0u;
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The wrapper's layer table (kernels/fused_message_generic.py::_layer_table,
// device memory): kLayer ints per message layer, in layer order.  The
// offsets are prefix sums over the layers before it: of the forward and the
// dm masks (words of the plan's mask array: fwd_blocks(D) x A x C1/16 and
// dm_blocks(C1) x A x D/16 a layer), of W' (elements of the layers'
// flat [A*C1, D] weights, and of the weight-gradient partials' rows), of the
// selections (dk), and, in units of N*K slot rows, of the per-slot buffers
// that hold one block of rows per layer (y: D wide; dy: D rounded up to 8;
// m: C1 rounded up to 16).
enum LayerField {
  kC1, kD, kDk, kMaskFwd, kMaskDm, kWOff, kSelOff, kYOff, kDyOff, kMOff, kGateOff, kLayer
};

__device__ __forceinline__ int layer_field(const int* __restrict__ layers, int l, int f) {
  return __ldg(layers + l * kLayer + f);
}

// Bytes of shared memory for the plan's tables: nmasks bit masks and a
// chunk table of at most nmasks + 1 entries (a chunk holds at least one row).
__host__ __device__ constexpr long table_bytes(int nmasks) {
  return (8L * nmasks + 4 + 15) / 16 * 16;
}

// shared memory of a ring of n stages: the stages, then the barriers
__host__ __device__ constexpr long ring_bytes(int n) { return (long)n * (kStageBytes + 16); }

// the deepest ring (kMinStages .. kMaxStages) that leaves a block of `other`
// bytes of shared memory beside it two blocks an SM
// column blocks of a layer's forward GEMM (over D) and of its dm GEMM (over C1)
__host__ __device__ constexpr int fwd_blocks(int d) {
  return (d + 8 * kBlockNT - 1) / (8 * kBlockNT);
}
__host__ __device__ constexpr int dm_blocks(int c1) {
  return (c1 + 8 * kBlockCT - 1) / (8 * kBlockCT);
}

__host__ __device__ inline int ring_stages(long other) {
  long n = (kTwoBlockSmem - other) / (kStageBytes + 16);
  return n < kMinStages ? kMinStages : n > kMaxStages ? kMaxStages : (int)n;
}

struct Ring {
  const bf16* src;        // the packed tiles of every stream
  const int* chunk0;      // [Q + 1] (shared): each chunk's first tile at src, then the end
  const int* q_base;      // [S + 1] (global): first chunk of each stream, then Q
  unsigned char* stage;   // [stages][kStageBytes]
  uint64_t* full;         // [stages]
  uint64_t* empty;        // [stages]
  int stages;
  int nq;                 // chunks of every stream: Q

  // carve a ring of n stages out of shared memory at p (16-byte aligned),
  // take the chunk table at chunks (shared) and the streams' first chunks
  // at qb (global, nq = Q); every thread calls it
  __device__ void setup(unsigned char* p, int n, const bf16* w, const int* chunks,
                        const int* qb, int q) {
    src = w;
    chunk0 = chunks;
    q_base = qb;
    stage = p;
    stages = n;
    nq = q;
    full = reinterpret_cast<uint64_t*>(p + (long)n * kStageBytes);
    empty = full + n;
  }
  __device__ int chunks() const { return nq; }

  // thread 0 copies chunk q into its stage, once every warp has released the
  // chunk that stage held (q - stages)
  __device__ void issue(int q) {
    if (q >= chunks()) return;
    const int st = q % stages;
    if (q >= stages) mbar_wait(empty + st, (uint32_t)((q / stages - 1) & 1));
    const int first = chunk0[q];
    const uint32_t bytes = (uint32_t)(chunk0[q + 1] - first) * kTileBytes;
    mbar_expect_tx(full + st, bytes);
    bulk_copy(stage + (long)st * kStageBytes, src + (long)first * 128, bytes, full + st);
  }

  // barriers initialised, the first chunks on their way; ends with a block
  // barrier
  __device__ void start(int nwarps) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < stages; ++i) {
        mbar_init(full + i, 1);
        mbar_init(empty + i, nwarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int q = 0; q < stages; ++q) issue(q);
    }
    __syncthreads();
  }

  // a warp is done with chunk q: one lane arrives; thread 0 then refills the
  // stage with chunk q + stages
  __device__ void release(int q, int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + q % stages);
    if (threadIdx.x == 0) issue(q + stages);
    __syncwarp();
  }
};

// The plan's masks (nmasks words) and chunk table (nq + 1 entries) from
// global memory into shared memory (masks_s, then the table), by every
// thread of the block; the caller's block barrier follows.
__device__ __forceinline__ void load_tables(const uint32_t* masks, int nmasks,
                                            const int* __restrict__ chunks, int nq,
                                            uint32_t* masks_s) {
  int* chunks_s = reinterpret_cast<int*>(masks_s + nmasks);
  for (int i = threadIdx.x; i < nmasks + nq + 1; i += blockDim.x) {
    if (i < nmasks) masks_s[i] = __ldg(masks + i);
    else chunks_s[i - nmasks] = __ldg(chunks + i - nmasks);
  }
}

// A warp's position in one stream: the next chunk, the next tile, and the
// current chunk's tiles [cs, ce) in its stage
struct Cursor {
  int q, q0;
  int i, cs, ce;
  const unsigned char* cur;
};

__device__ __forceinline__ Cursor open(const Ring& r, int stream) {
  Cursor c;
  c.q0 = c.q = __ldg(r.q_base + stream);
  c.i = c.cs = c.ce = r.chunk0[c.q];
  c.cur = nullptr;
  return c;
}

// a row of n > 0 tiles starts: past the current chunk, release it and wait
// for the next (the wrapper never splits a row)
__device__ __forceinline__ void row(Ring& r, Cursor& c, int n, int lane) {
  if (c.i + n > c.ce) {
    if (c.q > c.q0) r.release(c.q - 1, lane);
    const int st = c.q % r.stages;
    mbar_wait(r.full + st, (uint32_t)((c.q / r.stages) & 1));
    c.cs = c.i;
    c.ce = r.chunk0[c.q + 1];
    c.cur = r.stage + (long)st * kStageBytes;
    ++c.q;
  }
}

// the next tile's B fragment of this lane
__device__ __forceinline__ uint2 next_frag(Cursor& c, int lane) {
  const uint2 b = *reinterpret_cast<const uint2*>(c.cur + (c.i - c.cs) * kTileBytes + lane * 8);
  ++c.i;
  return b;
}

__device__ __forceinline__ void close(Ring& r, const Cursor& c, int lane) {
  if (c.q > c.q0) r.release(c.q - 1, lane);
}

// ---------------------------------------------------------------------------
// The three products, each over one column block.  M / DY are [rows][ld]
// bf16 in shared memory, the warp's rows r0 .. r0+15; geo [rows][gs] holds
// attr_c at column c (G: float or bf16).  masks: the block's [A][k-steps]
// bit masks over its n-tiles (in shared memory: a load per row on the
// critical path).  A row is one (c, k-step): a runtime loop over the k-steps,
// the n-tiles unrolled (their accumulators stay in registers).  The caller
// opens the GEMM's stream (open) before its first block and closes it
// (close) after its last: the cursor runs on from block to block.

// y = sum_c attr_c * (M @ W[c]): k-steps ks over C1 (ks_n), n-tiles nt over
// the block's columns of D; acc[nt] ends as the fp32 sum (columns nt*8 +
// 2 t4 (+1) of the block, rows g and g+8).
template <int MAX_NT, typename G>
__device__ __forceinline__ void gemm_fwd(Ring& r, Cursor& cur, const uint32_t* masks, int a,
                                         int ks_n, const bf16* M, int ldm, const G* geo, int gs,
                                         float (&acc)[MAX_NT][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
#pragma unroll
  for (int nt = 0; nt < MAX_NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const bf16* a0 = M + (r0 + g) * ldm + t4 * 2;
  const bf16* a1 = a0 + 8 * ldm;
  for (int c = 0; c < a; ++c) {
    float t[MAX_NT][4];
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt) t[nt][0] = t[nt][1] = t[nt][2] = t[nt][3] = 0.f;
    for (int ks = 0; ks < ks_n; ++ks) {
      const uint32_t m = masks[c * ks_n + ks];
      if (m == 0u) continue;
      row(r, cur, __popc(m), lane);
      uint32_t af[4];
      af[0] = *reinterpret_cast<const uint32_t*>(a0 + ks * 16);
      af[1] = *reinterpret_cast<const uint32_t*>(a1 + ks * 16);
      af[2] = *reinterpret_cast<const uint32_t*>(a0 + ks * 16 + 8);
      af[3] = *reinterpret_cast<const uint32_t*>(a1 + ks * 16 + 8);
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt) {
        if ((m >> nt) & 1u) {
          const uint2 b = next_frag(cur, lane);
          mma_bf16_16816(t[nt], af, b.x, b.y);
        }
      }
    }
    const float at0 = to_f(geo[(r0 + g) * gs + c]), at1 = to_f(geo[(r0 + g + 8) * gs + c]);
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt) {
      acc[nt][0] = __fadd_rn(acc[nt][0], __fmul_rn(at0, t[nt][0]));
      acc[nt][1] = __fadd_rn(acc[nt][1], __fmul_rn(at0, t[nt][1]));
      acc[nt][2] = __fadd_rn(acc[nt][2], __fmul_rn(at1, t[nt][2]));
      acc[nt][3] = __fadd_rn(acc[nt][3], __fmul_rn(at1, t[nt][3]));
    }
  }
}

// dm = sum_c (dy * attr_c, rounded to bf16) @ W[c]^T: k-steps ds over D
// (ds_n), n-tiles ct over the block's columns of C1; acc[ct] the fp32 sum,
// its products in (c, ds) order.
template <int MAX_CT, typename G>
__device__ __forceinline__ void gemm_dm(Ring& r, Cursor& cur, const uint32_t* masks, int a,
                                        int ds_n, const bf16* DY, int ldy, const G* geo, int gs,
                                        float (&acc)[MAX_CT][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
#pragma unroll
  for (int ct = 0; ct < MAX_CT; ++ct) acc[ct][0] = acc[ct][1] = acc[ct][2] = acc[ct][3] = 0.f;
  const bf16* a0 = DY + (r0 + g) * ldy + t4 * 2;
  const bf16* a1 = a0 + 8 * ldy;
  for (int c = 0; c < a; ++c) {
    const float at0 = to_f(geo[(r0 + g) * gs + c]), at1 = to_f(geo[(r0 + g + 8) * gs + c]);
    for (int ds = 0; ds < ds_n; ++ds) {
      const uint32_t m = masks[c * ds_n + ds];
      if (m == 0u) continue;
      row(r, cur, __popc(m), lane);
      uint32_t af[4];
      af[0] = scale2(a0 + ds * 16, at0);
      af[1] = scale2(a1 + ds * 16, at1);
      af[2] = scale2(a0 + ds * 16 + 8, at0);
      af[3] = scale2(a1 + ds * 16 + 8, at1);
#pragma unroll
      for (int ct = 0; ct < MAX_CT; ++ct) {
        if ((m >> ct) & 1u) {
          const uint2 b = next_frag(cur, lane);
          mma_bf16_16816(acc[ct], af, b.x, b.y);
        }
      }
    }
  }
}

// Kernel #14's dm (JAX's AD of the layer in bf16): components last first;
// per component and column tile, dm_c = attr_c * (dy @ W[c]^T) over the
// listed k-steps in a fresh fp32 accumulator t[ct], rounded to bf16 and
// added to the running bf16 sum (held in fp32 in acc).  The stream holds
// each block's components last first.
template <int MAX_CT, typename G>
__device__ __forceinline__ void gemm_dm_vjp(Ring& r, Cursor& cur, const uint32_t* masks, int a,
                                            int ds_n, const bf16* DY, int ldy, const G* geo,
                                            int gs, float (&acc)[MAX_CT][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const bf16* a0 = DY + (r0 + g) * ldy + t4 * 2;
  const bf16* a1 = a0 + 8 * ldy;
#pragma unroll
  for (int ct = 0; ct < MAX_CT; ++ct) acc[ct][0] = acc[ct][1] = acc[ct][2] = acc[ct][3] = 0.f;
  for (int i = 0; i < a; ++i) {
    const int c = a - 1 - i;
    float t[MAX_CT][4];
#pragma unroll
    for (int ct = 0; ct < MAX_CT; ++ct) t[ct][0] = t[ct][1] = t[ct][2] = t[ct][3] = 0.f;
    for (int ds = 0; ds < ds_n; ++ds) {
      const uint32_t m = masks[c * ds_n + ds];
      if (m == 0u) continue;
      row(r, cur, __popc(m), lane);
      uint32_t af[4];
      af[0] = *reinterpret_cast<const uint32_t*>(a0 + ds * 16);
      af[1] = *reinterpret_cast<const uint32_t*>(a1 + ds * 16);
      af[2] = *reinterpret_cast<const uint32_t*>(a0 + ds * 16 + 8);
      af[3] = *reinterpret_cast<const uint32_t*>(a1 + ds * 16 + 8);
#pragma unroll
      for (int ct = 0; ct < MAX_CT; ++ct) {
        if ((m >> ct) & 1u) {
          const uint2 b = next_frag(cur, lane);
          mma_bf16_16816(t[ct], af, b.x, b.y);
        }
      }
    }
    const float at0 = to_f(geo[(r0 + g) * gs + c]), at1 = to_f(geo[(r0 + g + 8) * gs + c]);
#pragma unroll
    for (int ct = 0; ct < MAX_CT; ++ct) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float dmc = __bfloat162float(__float2bfloat16(__fmul_rn(q < 2 ? at0 : at1, t[ct][q])));
        acc[ct][q] = i == 0 ? dmc : __bfloat162float(__float2bfloat16(__fadd_rn(acc[ct][q], dmc)));
      }
    }
  }
}

}  // namespace gmma
