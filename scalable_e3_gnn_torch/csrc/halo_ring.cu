// Kernel #15: the all-gather of the halo boundary pool, for Hopper (sm_90a).
//
// Replaces scalable_e3_gnn_tpu/kernels/halo_rdma.py::_fwd (:84, its
// pallas_call :101, the body _ring_kernel :43): every one of P ranks holds an
// export chunk [H, F]; afterwards every rank's pool [P, H, F] holds all
// ranks' chunks in rank order, pools[r, q] = exports[q].
//
// The TPU kernel is a ring of remote copies, P-1 rounds in series with a
// semaphore per round, because a chip writes only into its neighbour's
// memory.  Here the ranks are the partitions of one process on one card: the
// exports are one [P, H, F] array and the pools one [P, P, H, F] array (rank
// r's pool at pools + r*P*chunk), all in one address space, and the next
// kernel in the stream is the consumer.  Nothing has to wait inside the
// kernel, so it is an ordinary launch over the flat (q, offset) range of the
// exports: each thread loads one V-byte word of exports[q] once and stores
// it into slot q of all P pools, one load feeding P stores.  No rounds, no
// flags, no co-residency, no error word.
//
// A chunk is contiguous and chunk q of the exports sits at q*chunk, so the
// word at flat index i goes to pools[r*P*chunk + i] for every r.  V = 16
// bytes where the chunk's byte size and both base addresses allow, else 8, 4
// or 2: the tail path for odd H and F (the wrapper's plan).
//
// Bound: bytes.  The function reads every export once and writes every pool
// once, P + P^2 chunks at 3.35 TB/s, and the kernel moves exactly that.
//
// Across cards (ranks on peer-mapped H100s over NVLink) the same shape turns
// into a push of each rank's export into its peers' pools, with a completion
// protocol of its own (ROADMAP.md, module 6 item 1); one card needs none.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void halo_ring_kernel(const V* __restrict__ exports, V* __restrict__ pools, int p,
                                 long long chunk) {
  const long long n = (long long)p * chunk;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V v = exports[i];
  for (int r = 0; r < p; ++r) pools[r * n + i] = v;
}

template <typename V>
int launch(const void* exports, void* pools, int p, long long chunk, int threads,
           cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(exports) | reinterpret_cast<uintptr_t>(pools)) % sizeof(V))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)p * chunk;
  const long long grid = (n + threads - 1) / threads;
  halo_ring_kernel<V><<<(unsigned)grid, threads, 0, stream>>>(
      static_cast<const V*>(exports), static_cast<V*>(pools), p, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// exports [P, chunk] and pools [P, P, chunk] in words of vec_bytes; returns
// cudaGetLastError() after the launch.
extern "C" int halo_ring(int vec_bytes, const void* exports, void* pools, int p, long long chunk,
                         int threads, void* stream) {
  if (p < 1 || chunk < 1 || threads < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return launch<uint4>(exports, pools, p, chunk, threads, st);
    case 8: return launch<uint2>(exports, pools, p, chunk, threads, st);
    case 4: return launch<unsigned int>(exports, pools, p, chunk, threads, st);
    case 2: return launch<unsigned short>(exports, pools, p, chunk, threads, st);
  }
  return (int)cudaErrorInvalidValue;
}
