"""Ring all-gather of the halo boundary pool (kernel #15).

Counterpart of ``scalable_e3_gnn_tpu/kernels/halo_rdma.py::ring_all_gather``
(``_fwd`` :84, its ``pallas_call`` :101, ``_ring_kernel`` :43).  Each of P
ranks holds an export block [H, F]; afterwards every rank's pool [P, H, F]
is the stack of all ranks' exports, in rank order.  The TPU kernel runs a
pipelined ring of remote copies: each rank writes its own chunk into its own
slot, then in round s = 0..P-2 forwards slot (r - s) mod P to rank r + 1,
and round s's send waits only on round s-1's arrival (per-round semaphores).

Here the ranks are the partitions of one process, all on one card (the
group of ``parallel.halo``), so the exports come stacked as [P, H, F] and the
pools go out as [P, P, H, F] (rank r's pool is ``pools[r]``).  The CUDA
kernel (``csrc/halo_ring.cu``) keeps the TPU schedule: rank r's blocks store
straight into rank r+1's pool and then raise a per-round arrival flag there,
which rank r+1 acquires before it forwards that slot in the next round.  The
TPU's padding of H and F to sublane and lane tiles is a layout workaround and
is not carried over; the copy moves 16 bytes a thread where the chunk's byte
size allows, else one element.

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

Launch protocol.  The flags persist between launches and are never reset:
each launch raises them to a new epoch (a counter per flag buffer, advanced
by the wrapper), so a flag left by an earlier launch never satisfies a wait
of this one.  Every wait is bounded in time; a block that runs over writes an
error word and stops, and ``ring_error_check`` raises on it.  Reading the
word waits for the card, so only ``ring_all_gather_fwd`` with ``check=True``
(its default: a single checked call) reads it after its launch; the halo
exchange and ``ring_all_gather`` leave it to their caller: the partitioned
runners read it once per forward or train step.  Launches that share a flag buffer must be
ordered (one stream), as every launch of the port is.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel

__all__ = ["RingAllGather", "ring_all_gather", "ring_all_gather_fwd", "ring_all_gather_plain",
           "ring_all_gather_launch", "ring_epochs", "ring_error_check", "RING", "KERNELS"]

_P, _I, _L, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
RING = CudaKernel("halo_ring", {
    # vector bytes, threads per block: the most blocks that can be resident at
    # once on the current device (the cooperative launch's limit)
    "halo_ring_max_blocks": (_I, [_I, _I]),
    # vector bytes, exports, pools, flags, error word, P, blocks per rank,
    # vectors per chunk, epoch, timeout (ns), threads per block, stream
    "halo_ring": (_I, [_I, _P, _P, _P, _P, _I, _I, _L, _U, _L, _I, _P]),
})
KERNELS = (RING,)

THREADS = 256
# bytes of a chunk per block of a rank: enough blocks to spread a chunk over
# the card, few enough that every block of every rank is resident at once
BYTES_PER_BLOCK = 16384
# the bound of every wait of a launch: far beyond any chunk's transfer, short
# enough that a fault raises instead of hanging the card
TIMEOUT_NS = 2_000_000_000

# per (device, P, blocks per rank): [flags, last epoch]; per device: the error
# word; per (device, vector bytes): the occupancy query's most resident blocks
_STATE: dict = {}
_ERR: dict = {}
_MAX_BLOCKS: dict = {}


def ring_all_gather_plain(exports: torch.Tensor) -> torch.Tensor:
    """[P, H, F] exports -> [P, P, H, F] pools, ``pools[r, q] = exports[q]``."""
    p = exports.shape[0]
    return exports.unsqueeze(0).expand(p, *exports.shape).clone()


def _vector_bytes(chunk_bytes: int, *ptrs: int) -> int:
    """The widest of 16, 8, 4, 2 bytes that divides a chunk's bytes and every
    base address (the chunk starts are multiples of its size)."""
    for v in (16, 8, 4, 2):
        if chunk_bytes % v == 0 and all(x % v == 0 for x in ptrs):
            return v
    raise ValueError(f"no copy width for a chunk of {chunk_bytes} bytes")


def _blocks_per_rank(p: int, chunk_bytes: int, max_blocks: int) -> int:
    """Blocks per rank: one per BYTES_PER_BLOCK of a chunk, at least one, and
    at most what keeps all P ranks' blocks resident together."""
    if p > max_blocks:
        raise ValueError(f"{p} ranks need {p} co-resident blocks; the card holds {max_blocks}")
    return max(1, min(-(-chunk_bytes // BYTES_PER_BLOCK), max_blocks // p))


def _error_word(device: torch.device) -> torch.Tensor:
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.index not in _ERR:
        _ERR[device.index] = torch.zeros((1,), dtype=torch.int32, device=device)
    return _ERR[device.index]


def ring_all_gather_launch(exports: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA ``exports`` [P, H, F] (float32 or bfloat16,
    contiguous) and return the pools [P, P, H, F] without reading the error
    word: ``ring_error_check`` does, after one launch or many."""
    if exports.device.type != "cuda":
        raise ValueError(f"no kernel for device {exports.device}")
    if exports.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16, not {exports.dtype}")
    if exports.dim() != 3 or not exports.is_contiguous():
        raise ValueError("exports must be a contiguous [P, H, F] tensor")
    p, h, f = exports.shape
    pools = torch.empty((p, p, h, f), dtype=exports.dtype, device=exports.device)
    chunk_bytes = h * f * exports.element_size()
    if chunk_bytes == 0:
        return pools
    vec = _vector_bytes(chunk_bytes, exports.data_ptr(), pools.data_ptr())
    lib = RING.lib()
    blocks_key = (exports.device.index, vec)
    if blocks_key not in _MAX_BLOCKS:
        with torch.cuda.device(exports.device):
            max_blocks = lib.halo_ring_max_blocks(vec, THREADS)
        if max_blocks < 1:
            raise RuntimeError(
                f"halo_ring: no occupancy for {THREADS} threads (code {max_blocks})")
        _MAX_BLOCKS[blocks_key] = max_blocks
    groups = _blocks_per_rank(p, chunk_bytes, _MAX_BLOCKS[blocks_key])
    key = (exports.device.index, p, groups)
    if key not in _STATE:
        _STATE[key] = [torch.zeros((p, max(p - 1, 1), groups), dtype=torch.int32,
                                   device=exports.device), 0]
    state = _STATE[key]
    if state[1] == 2 ** 32 - 1:  # the epoch wraps: start the flags afresh
        state[0].zero_()
        state[1] = 0
    state[1] += 1
    err = _error_word(exports.device)
    stream = torch.cuda.current_stream(exports.device).cuda_stream
    with torch.cuda.device(exports.device):
        rc = lib.halo_ring(vec, exports.data_ptr(), pools.data_ptr(), state[0].data_ptr(),
                           err.data_ptr(), p, groups, chunk_bytes // vec, state[1],
                           TIMEOUT_NS, THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"halo_ring launch failed with CUDA error {rc}")
    RING.launches += 1
    return pools


def ring_epochs() -> dict:
    """{(device index, P, blocks per rank): the epoch of the last launch} of
    every flag buffer made so far."""
    return {key: state[1] for key, state in _STATE.items()}


def ring_error_check(device: torch.device) -> None:
    """Raise if a launch on ``device`` ran over its wait bound (reads the
    error word, so it waits for the launches before it), clearing the word."""
    err = _error_word(torch.device(device))
    code = int(err.item())
    if code != 0:
        err.zero_()
        raise RuntimeError(
            f"halo_ring: block {code & 0xFFFF} of rank {(code >> 16) - 1} waited past its "
            "bound for a chunk to arrive")


def ring_all_gather_fwd(exports: torch.Tensor, check: bool = True) -> torch.Tensor:
    """[P, H, F] -> [P, P, H, F]: the CUDA kernel for a CUDA tensor (float32 or
    bfloat16, contiguous), the plain version for a CPU tensor.  ``check``:
    read the error word after the launch and raise if a wait ran over (this
    waits for the card); without it the caller runs ``ring_error_check``."""
    if exports.device.type == "cpu":
        return ring_all_gather_plain(exports)
    pools = ring_all_gather_launch(exports)
    if check:
        ring_error_check(exports.device)
    return pools


class RingAllGather(torch.autograd.Function):
    """``ring_all_gather_fwd`` without the error-word read, with the gradient
    of an all-gather: the reduce-scatter ``d_x[p] = sum_q g[q, p]``, summed
    in rank order."""

    @staticmethod
    def forward(ctx, exports):
        return ring_all_gather_fwd(exports, check=False)

    @staticmethod
    def backward(ctx, g):
        d = g[0].clone()
        for q in range(1, g.shape[0]):
            d = d + g[q]
        return d


def ring_all_gather(exports: torch.Tensor) -> torch.Tensor:
    """[P, H, F] exports of P ranks -> [P, P, H, F] pools (rank r's pool is
    ``pools[r]``, equal to the stack of all exports), differentiable.  On a
    CUDA tensor the caller reads the error word (``ring_error_check``) once
    its launches are queued."""
    return RingAllGather.apply(exports)
