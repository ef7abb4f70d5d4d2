// Kernel #15: the ring all-gather of the halo boundary pool, for Hopper
// (sm_90a).
//
// Replaces scalable_e3_gnn_tpu/kernels/halo_rdma.py::_fwd (:84, its
// pallas_call :101, the body _ring_kernel :43): every one of P ranks holds an
// export chunk [H, F]; afterwards every rank's pool [P, H, F] holds all
// ranks' chunks in rank order.  The TPU schedule is kept: rank r first
// writes its own chunk into its own slot; in round s = 0..P-2 it forwards
// slot (r - s) mod P to rank r + 1; round s's send waits only on round
// s-1's arrival at rank r, through a flag of that round alone.
//
// Layout: the ranks are the partitions of one process on one card, so the
// exports are one [P, H, F] array and the pools one [P, P, H, F] array (rank
// r's pool at pools + r*P*chunk).  A chunk is contiguous, so it is copied as
// a flat run of V-sized words (V = 16 bytes where the chunk's byte size and
// the base addresses allow, else 8, 4 or 2: the tail path for any F).
//
// Work split: each rank has G blocks and block g of every rank owns the same
// slice of every chunk.  Block g of rank r forwards, in round s, the slice
// that block g of rank r-1 wrote in round s-1, so it waits on that block's
// flag alone: flags[rank][round][g], no barrier among a rank's blocks.
//
// Co-residency: a block spins until another block has raised its flag, so
// every block of every rank must be resident at once, or a spinning block
// could hold the SM that the block it waits for needs.  The launch is
// cooperative (cudaLaunchCooperativeKernel), which refuses a grid that
// cannot be resident at once; the wrapper sizes the grid below the
// occupancy query halo_ring_max_blocks.
//
// No reset between launches: the flags are never cleared.  A launch raises
// its flags to its own epoch (the wrapper's counter, advanced per launch),
// and a wait is for that exact epoch, so a flag left by an earlier launch
// cannot satisfy it.
//
// Memory ordering: a writer block stores its slice into the right
// neighbour's pool, then __syncthreads (the block's stores precede thread
// 0's), then thread 0 fences and stores the flag with release semantics.
// The reader's thread 0 loads the flag with acquire semantics, then
// __syncthreads, then the block reads the slice from L2 (ld.global.cg).  All
// of it at .gpu scope (RING_SCOPE): ranks on distinct peer-mapped cards would
// change that one word to .sys.
//
// No hang: every wait is bounded by the globaltimer.  A block that runs over
// records ((rank + 1) << 16) | g in the error word and stops; the blocks that
// wait on it then run over as well.  The wrapper raises on the word.
//
// Bound: bytes.  The function reads every export once and writes every pool
// once, (P + P^2) chunks at 3.35 TB/s.  The ring moves more: each rank reads
// its export and the P-1 chunks it forwards and writes P chunks, 2 * P^2
// chunks, with P-1 rounds of flag latency in series on top.

#include <cuda_runtime.h>
#include <stdint.h>

#define RING_SCOPE "gpu"

namespace {

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire." RING_SCOPE ".global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release." RING_SCOPE ".global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <typename V>
__global__ void ring_kernel(const V* __restrict__ exports, V* pools, unsigned* flags, int* err,
                            int p, int groups, long long chunk, unsigned epoch,
                            long long timeout_ns) {
  __shared__ int stop;
  const int rank = blockIdx.x / groups;
  const int g = blockIdx.x % groups;
  const int right = (rank + 1) % p;
  const long long per = (chunk + groups - 1) / groups;
  const long long lo = g * per;
  const long long hi = lo + per < chunk ? lo + per : chunk;
  V* mine = pools + (long long)rank * p * chunk;
  V* next = pools + (long long)right * p * chunk;
  const int rounds = p - 1;

  // the local chunk into this rank's own slot
  const V* src = exports + (long long)rank * chunk;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) mine[rank * chunk + i] = src[i];

  for (int s = 0; s < rounds; ++s) {
    const int slot = (rank - s + p) % p;
    if (s > 0) {
      // the data gate: round s-1's chunk has arrived here
      if (threadIdx.x == 0) {
        const unsigned* f = flags + ((long long)rank * rounds + (s - 1)) * groups + g;
        const unsigned long long t0 = now_ns();
        int over = 0;
        while (load_acquire(f) != epoch) {
          if (now_ns() - t0 > (unsigned long long)timeout_ns) {
            atomicCAS(err, 0, ((rank + 1) << 16) | g);
            over = 1;
            break;
          }
          __nanosleep(64);
        }
        stop = over;
      }
      __syncthreads();
      if (stop) return;
    }
    // forward this slice of slot (rank - s) to the right neighbour's pool
    const V* from = mine + (long long)slot * chunk;
    V* to = next + (long long)slot * chunk;
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) to[i] = __ldcg(from + i);
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      store_release(flags + ((long long)right * rounds + s) * groups + g, epoch);
    }
  }
}

template <typename V>
int max_blocks(int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -2;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_kernel<V>, threads, 0) !=
      cudaSuccess)
    return -3;
  return per_sm * sms;
}

template <typename V>
int launch(const void* exports, void* pools, void* flags, void* err, int p, int groups,
           long long chunk, unsigned epoch, long long timeout_ns, int threads,
           cudaStream_t stream) {
  const V* ex = static_cast<const V*>(exports);
  V* po = static_cast<V*>(pools);
  unsigned* fl = static_cast<unsigned*>(flags);
  int* er = static_cast<int*>(err);
  void* args[] = {(void*)&ex, (void*)&po, (void*)&fl, (void*)&er, (void*)&p,
                  (void*)&groups, (void*)&chunk, (void*)&epoch, (void*)&timeout_ns};
  cudaError_t rc = cudaLaunchCooperativeKernel((const void*)ring_kernel<V>, dim3(p * groups),
                                               dim3(threads), args, 0, stream);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int halo_ring_max_blocks(int vec_bytes, int threads) {
  switch (vec_bytes) {
    case 16: return max_blocks<uint4>(threads);
    case 8: return max_blocks<uint2>(threads);
    case 4: return max_blocks<unsigned int>(threads);
    case 2: return max_blocks<unsigned short>(threads);
  }
  return -4;
}

extern "C" int halo_ring(int vec_bytes, const void* exports, void* pools, void* flags, void* err,
                         int p, int groups, long long chunk, unsigned epoch,
                         long long timeout_ns, int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16:
      return launch<uint4>(exports, pools, flags, err, p, groups, chunk, epoch, timeout_ns,
                           threads, st);
    case 8:
      return launch<uint2>(exports, pools, flags, err, p, groups, chunk, epoch, timeout_ns,
                           threads, st);
    case 4:
      return launch<unsigned int>(exports, pools, flags, err, p, groups, chunk, epoch,
                                  timeout_ns, threads, st);
    case 2:
      return launch<unsigned short>(exports, pools, flags, err, p, groups, chunk, epoch,
                                    timeout_ns, threads, st);
  }
  return (int)cudaErrorInvalidValue;
}
