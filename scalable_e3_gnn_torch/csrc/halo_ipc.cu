// Kernel #15 between processes: the all-gather of the halo boundary pool
// for ranks that share one card, for Hopper (sm_90a).
//
// Replaces scalable_e3_gnn_tpu/kernels/halo_rdma.py::_fwd (:84, its
// pallas_call :101, the body _ring_kernel :43) where the devices of the ring
// are processes: each of W ranks holds the exports of its P_local
// partitions, [P_local, H, F]; afterwards every rank holds the pool
// [P, H, F] (P = W * P_local), pool[q] = exports of partition q.
//
// The TPU kernel runs P-1 rounds of remote copies because a chip writes only
// into its neighbour.  On one card every rank can read every other rank's
// memory, so there are no rounds: each rank copies its exports into a
// staging buffer of its own that the other ranks have mapped (CUDA IPC), and
// raises a flag; each rank then pulls every rank's staging buffer into its
// pool once its flag is up.  Two kernels, so that the interior work of a
// layer runs between them:
//
//   publish  exports -> own staging buffer b = e mod 2, then flag[b] = e
//            (the last block to finish sets it, with release semantics at
//            system scope, after every block's stores);
//   gather   per rank q: wait until q's flag[b] >= e (an acquire load at
//            system scope, bounded in time), then copy q's staging buffer
//            into pool[q * P_local : (q + 1) * P_local].
//
// Each rank's region (one cudaMalloc, exported once by cudaIpcGetMemHandle):
//   [0, 16)    flag[0], flag[1]      u64, the last exchange published there
//   [16, 24)   count[0], count[1]    u32, blocks of a publish that finished
//   [256, ...) staging buffer 0, then buffer 1, each `stride` bytes
// The launches take the byte offsets of buffer b's flag, count and staging
// buffer from kernels/halo_ring.py::ipc_layout, the one place they are set.
//
// Why two buffers suffice: a rank publishes exchange e+2 into buffer b only
// after its gather of e+1 saw every peer's flag at e+1 (the same stream
// orders them); each peer published e+1 after its own gather of e, on its
// stream, so every read of buffer b for exchange e has ended.
//
// Visibility: the flag is read with ld.acquire.sys by one thread a block,
// then a barrier; the staging data is read with ld.global.cg (L2, never a
// stale L1 line); the publisher fences each block's stores before it counts
// the block, and the last block fences at system scope before its release
// store, so the same code holds for peer-mapped memory across cards.
//
// A dead or late peer: the wait is bounded by the global timer (wall-clock
// nanoseconds, which, unlike clock64's SM cycles, keep counting while another
// process's context holds the card).  Past the bound the block fills its
// slice of the pool with all-ones words (NaN in float32 and bfloat16) and,
// unless an earlier failure is there, stores (epoch << 16) | (q + 1) into
// the rank's error word, a host-mapped word that the host reads and raises
// on (a plain load and store: host memory over PCIe takes no atomics; blocks
// that race write failures of the same gather).  Nothing waits forever.
//
// Time-slicing: the ranks are separate CUDA contexts, which the card runs in
// turns (no MPS).  A gather that waits holds its turn until the time slice
// ends; what that costs is measured on the card (chip_smoke.py, ring_procs),
// not assumed.
//
// Bound: bytes.  Publish reads P_local chunks and writes P_local; gather
// reads W * P_local = P chunks and writes P, at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxWorld = 64;
constexpr long long kHeader = 256;

struct Peers {
  const unsigned char* base[kMaxWorld];
};

__device__ __forceinline__ unsigned long long ld_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <typename V>
__device__ __forceinline__ V all_ones();
template <>
__device__ __forceinline__ uint4 all_ones<uint4>() {
  return make_uint4(~0u, ~0u, ~0u, ~0u);
}
template <>
__device__ __forceinline__ uint2 all_ones<uint2>() {
  return make_uint2(~0u, ~0u);
}
template <>
__device__ __forceinline__ unsigned int all_ones<unsigned int>() {
  return ~0u;
}
template <>
__device__ __forceinline__ unsigned short all_ones<unsigned short>() {
  return (unsigned short)0xffff;
}

template <typename V>
__global__ void publish_kernel(const V* __restrict__ exports, unsigned char* region,
                               long long flag_off, long long count_off, long long stage_off,
                               unsigned long long epoch, long long words) {
  V* dst = reinterpret_cast<V*>(region + stage_off);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < words; i += stride)
    dst[i] = exports[i];
  __threadfence();  // this thread's stores before the block is counted
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int* count = reinterpret_cast<unsigned int*>(region + count_off);
    const unsigned int done = atomicAdd(count, 1u);
    if (done == gridDim.x - 1) {  // the last block: every other block's stores are fenced
      __threadfence();
      atomicExch(count, 0u);  // the next publish into this buffer counts from 0
      __threadfence_system();
      st_release_sys(reinterpret_cast<unsigned long long*>(region + flag_off), epoch);
    }
  }
}

template <typename V>
__global__ void gather_kernel(Peers peers, long long flag_off, long long stage_off,
                              unsigned long long epoch, long long words, int blocks_per_rank,
                              V* __restrict__ pool, unsigned long long* err,
                              long long timeout_ns) {
  const int q = blockIdx.x / blocks_per_rank;
  const int blk = blockIdx.x % blocks_per_rank;
  const unsigned char* base = peers.base[q];
  __shared__ int ready;
  if (threadIdx.x == 0) {
    const unsigned long long* flag = reinterpret_cast<const unsigned long long*>(base + flag_off);
    const unsigned long long t0 = global_ns();
    int ok = 1;
    while (ld_acquire_sys(flag) < epoch) {
      if ((long long)(global_ns() - t0) > timeout_ns) {
        ok = 0;
        volatile unsigned long long* word = err;
        if (*word == 0) *word = (epoch << 16) | (unsigned)(q + 1);  // the first failure stays
        __threadfence_system();
        break;
      }
      __nanosleep(200);
    }
    ready = ok;
  }
  __syncthreads();
  const V* src = reinterpret_cast<const V*>(base + stage_off);
  V* dst = pool + (long long)q * words;
  const long long stride = (long long)blocks_per_rank * blockDim.x;
  if (ready) {
    for (long long i = (long long)blk * blockDim.x + threadIdx.x; i < words; i += stride)
      dst[i] = __ldcg(src + i);
  } else {
    for (long long i = (long long)blk * blockDim.x + threadIdx.x; i < words; i += stride)
      dst[i] = all_ones<V>();
  }
}

// The offsets of buffer b within a region: a u64 flag, a u32 count, a
// staging buffer of vec_bytes words, each on its own alignment.
bool offsets_ok(long long flag_off, long long count_off, long long stage_off, int vec_bytes) {
  return flag_off >= 0 && flag_off % 8 == 0 && flag_off + 8 <= kHeader && count_off >= 0 &&
         count_off % 4 == 0 && count_off + 4 <= kHeader && stage_off >= kHeader &&
         stage_off % vec_bytes == 0;
}

template <typename V>
int launch_publish(const void* exports, void* region, long long flag_off, long long count_off,
                   long long stage_off, unsigned long long epoch, long long words, int blocks,
                   int threads, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(exports) % sizeof(V)) return (int)cudaErrorInvalidValue;
  publish_kernel<V><<<blocks, threads, 0, stream>>>(
      static_cast<const V*>(exports), static_cast<unsigned char*>(region), flag_off, count_off,
      stage_off, epoch, words);
  return (int)cudaGetLastError();
}

template <typename V>
int launch_gather(const Peers& peers, int world, long long flag_off, long long stage_off,
                  unsigned long long epoch, long long words, int blocks_per_rank, void* pool,
                  unsigned long long* err, long long timeout_ns, int threads,
                  cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(pool) % sizeof(V)) return (int)cudaErrorInvalidValue;
  gather_kernel<V><<<world * blocks_per_rank, threads, 0, stream>>>(
      peers, flag_off, stage_off, epoch, words, blocks_per_rank, static_cast<V*>(pool), err,
      timeout_ns);
  return (int)cudaGetLastError();
}

}  // namespace

// The region of a rank: `bytes` of device memory, zeroed (flags at 0).
extern "C" int halo_ipc_alloc(long long bytes, void** region) {
  if (bytes < kHeader || region == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaMalloc(region, (size_t)bytes);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaMemset(*region, 0, (size_t)bytes);
  if (rc == cudaSuccess) rc = cudaDeviceSynchronize();
  return (int)rc;
}

extern "C" int halo_ipc_free(void* region) { return (int)cudaFree(region); }

// The region's IPC handle, copied into `handle` (64 bytes).
extern "C" int halo_ipc_handle(void* region, void* handle) {
  cudaIpcMemHandle_t h;
  cudaError_t rc = cudaIpcGetMemHandle(&h, region);
  if (rc == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return (int)rc;
}

extern "C" int halo_ipc_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

// A peer's region, mapped into this process from its 64-byte handle.
extern "C" int halo_ipc_open(const void* handle, void** region) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(region, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int halo_ipc_close(void* region) { return (int)cudaIpcCloseMemHandle(region); }

// The error word: 8 bytes of mapped, page-locked host memory, zeroed; its
// host address and the address the kernels write it through.
extern "C" int halo_ipc_error_word(void** host, void** device) {
  cudaError_t rc = cudaHostAlloc(host, 8, cudaHostAllocMapped);
  if (rc != cudaSuccess) return (int)rc;
  memset(*host, 0, 8);
  return (int)cudaHostGetDevicePointer(device, *host, 0);
}

extern "C" int halo_ipc_free_error_word(void* host) { return (int)cudaFreeHost(host); }

extern "C" int halo_ipc_synchronize() { return (int)cudaDeviceSynchronize(); }

// exports [words of vec_bytes] -> the region's staging buffer at stage_off,
// then the flag at flag_off = epoch (the count at count_off counts the
// blocks); returns cudaGetLastError() after the launch.
extern "C" int halo_ipc_publish(int vec_bytes, const void* exports, void* region,
                                long long flag_off, long long count_off, long long stage_off,
                                unsigned long long epoch, long long words, int blocks,
                                int threads, void* stream) {
  if (words < 1 || blocks < 1 || threads < 1 ||
      !offsets_ok(flag_off, count_off, stage_off, vec_bytes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return launch_publish<uint4>(exports, region, flag_off, count_off, stage_off, epoch, words, blocks, threads, st);
    case 8: return launch_publish<uint2>(exports, region, flag_off, count_off, stage_off, epoch, words, blocks, threads, st);
    case 4: return launch_publish<unsigned int>(exports, region, flag_off, count_off, stage_off, epoch, words, blocks, threads, st);
    case 2: return launch_publish<unsigned short>(exports, region, flag_off, count_off, stage_off, epoch, words, blocks, threads, st);
  }
  return (int)cudaErrorInvalidValue;
}

// regions[0..world) (this process's addresses of every rank's region, its
// own among them) -> pool [world, words of vec_bytes], each rank's staging
// buffer at stage_off once its flag at flag_off reads at least `epoch`; a
// wait past `timeout_ns` writes the error word.  Returns cudaGetLastError().
extern "C" int halo_ipc_gather(int vec_bytes, const void* const* regions, int world,
                               long long flag_off, long long stage_off, unsigned long long epoch,
                               long long words, int blocks_per_rank, void* pool, void* err,
                               long long timeout_ns, int threads, void* stream) {
  if (world < 1 || world > kMaxWorld || words < 1 || blocks_per_rank < 1 || threads < 1 ||
      err == nullptr || !offsets_ok(flag_off, 0, stage_off, vec_bytes))
    return (int)cudaErrorInvalidValue;
  Peers peers;
  for (int q = 0; q < world; ++q) peers.base[q] = static_cast<const unsigned char*>(regions[q]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* e = static_cast<unsigned long long*>(err);
  switch (vec_bytes) {
    case 16: return launch_gather<uint4>(peers, world, flag_off, stage_off, epoch, words, blocks_per_rank, pool, e, timeout_ns, threads, st);
    case 8: return launch_gather<uint2>(peers, world, flag_off, stage_off, epoch, words, blocks_per_rank, pool, e, timeout_ns, threads, st);
    case 4: return launch_gather<unsigned int>(peers, world, flag_off, stage_off, epoch, words, blocks_per_rank, pool, e, timeout_ns, threads, st);
    case 2: return launch_gather<unsigned short>(peers, world, flag_off, stage_off, epoch, words, blocks_per_rank, pool, e, timeout_ns, threads, st);
  }
  return (int)cudaErrorInvalidValue;
}
