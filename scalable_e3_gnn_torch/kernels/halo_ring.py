"""All-gather of the halo boundary pool (kernel #15, the halo ring).

Counterpart of ``scalable_e3_gnn_tpu/kernels/halo_rdma.py::ring_all_gather``
(``_fwd`` :84, its ``pallas_call`` :101, ``_ring_kernel`` :43).  Each of P
ranks holds an export block [H, F]; afterwards every rank's pool [P, H, F]
is the stack of all ranks' exports, in rank order: ``pools[r, q] =
exports[q]``.  The TPU kernel runs a pipelined ring of remote copies between
chips: each rank writes its own chunk into its own slot, then in round s =
0..P-2 forwards slot (r - s) mod P to rank r + 1.

Here the ranks are the partitions of one process, all on one card (the
group of ``parallel.halo``), so the exports come stacked as [P, H, F] and the
pools go out as [P, P, H, F] (rank r's pool is ``pools[r]``).  On one card
nothing has to travel round a ring: the CUDA kernel (``csrc/halo_ring.cu``)
is one ordinary launch in which each thread loads a word of the exports
once and stores it into all P pools, so it moves the function's own bytes
(P + P^2 chunks) and nothing waits inside it.  The TPU's padding of H and F
to sublane and lane tiles is a layout workaround and is not carried over;
the copy moves 16 bytes a thread where the chunk's byte size and the base
addresses allow, else 8, 4 or 2 (``ring_plan``).

- ``ring_all_gather_plain``: ``exports.unsqueeze(0).expand(P, P, H, F)
  .clone()``, the same pools by PyTorch (the tests and the on-card checks).
- ``ring_all_gather_fwd``: the kernel for a CUDA tensor, the plain version
  for a CPU tensor.
- ``ring_all_gather``: differentiable (``RingAllGather``).  Its backward is
  the reduce-scatter ``d_x[p] = sum_q g[q, p]``, summed in rank order, in
  PyTorch: the JAX backward is XLA's ``psum_scatter``, not a Pallas kernel.
  The halo exchange (``parallel.halo``) calls ``ring_all_gather_fwd``
  inside its own autograd function, whose backward folds this reduce-scatter
  into the scatter of the halo cotangents.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel

__all__ = ["RingAllGather", "ring_all_gather", "ring_all_gather_fwd", "ring_all_gather_plain",
           "ring_plan", "RING", "KERNELS"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
RING = CudaKernel("halo_ring", {
    # vector bytes, exports, pools, P, vectors per chunk, threads per block, stream
    "halo_ring": (_I, [_I, _P, _P, _I, _L, _I, _P]),
})
KERNELS = (RING,)

THREADS = 256


def ring_all_gather_plain(exports: torch.Tensor) -> torch.Tensor:
    """[P, H, F] exports -> [P, P, H, F] pools, ``pools[r, q] = exports[q]``."""
    p = exports.shape[0]
    return exports.unsqueeze(0).expand(p, *exports.shape).clone()


def ring_plan(p: int, chunk_bytes: int, ptrs) -> dict:
    """The kernel's launch for P chunks of ``chunk_bytes`` bytes each at base
    addresses ``ptrs`` (exports, pools): ``vec_bytes``, the widest of 16, 8,
    4, 2 bytes that divides the chunk's bytes and every base (the chunk
    starts are multiples of its size); ``chunk`` words a chunk; ``grid``
    blocks of THREADS, one word of the exports a thread."""
    for v in (16, 8, 4, 2):
        if chunk_bytes % v == 0 and all(x % v == 0 for x in ptrs):
            chunk = chunk_bytes // v
            return dict(vec_bytes=v, chunk=chunk, threads=THREADS,
                        grid=-(-p * chunk // THREADS))
    raise ValueError(f"no copy width for a chunk of {chunk_bytes} bytes")


def ring_all_gather_fwd(exports: torch.Tensor) -> torch.Tensor:
    """[P, H, F] -> [P, P, H, F]: the CUDA kernel for a CUDA tensor (float32 or
    bfloat16, contiguous), the plain version for a CPU tensor."""
    if exports.device.type == "cpu":
        return ring_all_gather_plain(exports)
    if exports.device.type != "cuda":
        raise ValueError(f"no kernel for device {exports.device}")
    if exports.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16, not {exports.dtype}")
    if exports.dim() != 3 or not exports.is_contiguous():
        raise ValueError("exports must be a contiguous [P, H, F] tensor")
    p, h, f = exports.shape
    pools = torch.empty((p, p, h, f), dtype=exports.dtype, device=exports.device)
    chunk_bytes = h * f * exports.element_size()
    if p == 0 or chunk_bytes == 0:
        return pools
    plan = ring_plan(p, chunk_bytes, (exports.data_ptr(), pools.data_ptr()))
    stream = torch.cuda.current_stream(exports.device).cuda_stream
    with torch.cuda.device(exports.device):
        rc = RING.lib().halo_ring(plan["vec_bytes"], exports.data_ptr(), pools.data_ptr(), p,
                                  plan["chunk"], THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"halo_ring launch failed with CUDA error {rc}")
    RING.launches += 1
    return pools


class RingAllGather(torch.autograd.Function):
    """``ring_all_gather_fwd`` with the gradient of an all-gather: the
    reduce-scatter ``d_x[p] = sum_q g[q, p]``, summed in rank order."""

    @staticmethod
    def forward(ctx, exports):
        return ring_all_gather_fwd(exports)

    @staticmethod
    def backward(ctx, g):
        d = g[0].clone()
        for q in range(1, g.shape[0]):
            d = d + g[q]
        return d


def ring_all_gather(exports: torch.Tensor) -> torch.Tensor:
    """[P, H, F] exports of P ranks -> [P, P, H, F] pools (rank r's pool is
    ``pools[r]``, equal to the stack of all exports), differentiable."""
    return RingAllGather.apply(exports)
