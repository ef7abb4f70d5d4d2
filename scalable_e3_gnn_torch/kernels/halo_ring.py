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

Between processes (``IpcRing``, ``csrc/halo_ipc.cu``): the ranks of a
process group that share one card, each with the exports of its P_local
partitions [P_local, H, F]; every rank ends with the pool [P, H, F].  Each
rank owns a region of device memory (``cudaMalloc`` in the library, never
PyTorch's caching allocator, whose blocks are sub-allocated) holding two
flags, two block counts and two staging buffers at the offsets of
``ipc_layout``, which the launches pass to the kernels.  The region is
allocated once, at the ring's first publish, for that exchange's size
(every exchange of a group has the one size of its halo exports), and
exported by ``cudaIpcGetMemHandle``; the 64-byte handles are all-gathered
over the group's gloo process group and every rank maps its peers' regions
(``cudaIpcOpenMemHandle``).  An exchange e (``begin``) has parity b = e mod 2
(``ipc_parity``):

- ``publish``: a kernel copies the rank's exports into its staging buffer b
  and sets its flag b to e (release, system scope);
- ``gather``: a kernel waits until every rank's flag b reads at least e
  (acquire, system scope, bounded in time), then copies every rank's staging
  buffer into a fresh pool, rank q's at slot ``q * P_local`` (rank q owns
  partitions ``[q * P_local, (q + 1) * P_local)``).

Two buffers suffice: a rank publishes e+2 into buffer b only after its
gather of e+1 saw every peer's flag at e+1, and each peer published e+1 after
its own gather of e, on the same stream, so no read of buffer b for e is
left.  The counter e belongs to the group (``parallel.halo.PartitionGroup``
holds one ring), rises by one an exchange across layers and steps
and starts again only with a new world: a restarted process
builds a new group, new regions and new handles, so no handle outlives its
incarnation.

What can go wrong, and what covers it:
- visibility: the flags are read by ``ld.acquire.sys`` and written by
  ``st.release.sys`` after fences, the staging data read through L2;
- time-slicing: the ranks are CUDA contexts that the card runs in turns (no
  MPS), so a gather that waits spins until its time slice ends; its cost is
  measured on the card (``chip_smoke.py``, phase ``ring_procs``);
- a dead peer: the wait is bounded (``timeout_s``, the global timer); past it
  the kernel fills that rank's slots with NaN and writes the error word, a
  mapped host word that ``raise_if_failed`` reads and raises
  ``RuntimeError`` on; ``gather`` reads it before each launch, and the
  partitioned runners (``parallel.halo``) read it at the end of every
  forward, after a synchronisation of the stream, so no pool filled with
  NaN leaves a forward unreported;
- ranks on distinct cards: ``parallel.halo`` gathers the ranks' card UUIDs
  (``parallel.multihost.card_identities``) and raises ``NotImplementedError``
  before any ring exists; a failed allocation, IPC open or launch raises
  ``RuntimeError``.  Nothing falls back to gloo for a CUDA tensor;
- the regions are freed and the handles closed by ``close`` (after a
  synchronisation and a barrier of the group) or, without the barrier, when
  the ring is collected.

On the CPU the exchange between processes is its plain version, the
group's gloo ``all_gather`` (``parallel.halo.PartitionGroup``).
"""

from __future__ import annotations

import contextlib
import ctypes
import weakref
from typing import List, Optional

import torch
import torch.distributed as dist

from .build import CudaKernel

__all__ = ["RingAllGather", "ring_all_gather", "ring_all_gather_fwd", "ring_all_gather_plain",
           "ring_plan", "RING", "KERNELS", "IPC_PUBLISH", "IPC_GATHER", "IpcRing",
           "ipc_layout", "ipc_parity", "ipc_plan", "RING_WAIT_S"]

_P, _I, _L, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
RING = CudaKernel("halo_ring", {
    # vector bytes, exports, pools, P, vectors per chunk, threads per block, stream
    "halo_ring": (_I, [_I, _P, _P, _I, _L, _I, _P]),
})
_IPC = {
    "halo_ipc_alloc": (_I, [_L, ctypes.POINTER(_P)]),
    "halo_ipc_free": (_I, [_P]),
    "halo_ipc_handle": (_I, [_P, _P]),
    "halo_ipc_handle_bytes": (_I, []),
    "halo_ipc_open": (_I, [_P, ctypes.POINTER(_P)]),
    "halo_ipc_close": (_I, [_P]),
    "halo_ipc_error_word": (_I, [ctypes.POINTER(_P), ctypes.POINTER(_P)]),
    "halo_ipc_free_error_word": (_I, [_P]),
    "halo_ipc_synchronize": (_I, []),
    # vector bytes, exports, region, flag, count and staging buffer offsets, epoch, words,
    # blocks, threads, stream
    "halo_ipc_publish": (_I, [_I, _P, _P, _L, _L, _L, _U, _L, _I, _I, _P]),
    # vector bytes, regions, world, flag and staging buffer offsets, epoch, words, blocks
    # per rank, pool, error word, timeout ns, threads, stream
    "halo_ipc_gather": (_I, [_I, ctypes.POINTER(_P), _I, _L, _L, _U, _L, _I, _P, _P, _L, _I,
                             _P]),
}
IPC_PUBLISH = CudaKernel("halo_ipc_publish", _IPC, source_name="halo_ipc")
IPC_GATHER = CudaKernel("halo_ipc_gather", _IPC, source_name="halo_ipc")
KERNELS = (RING, IPC_PUBLISH, IPC_GATHER)

THREADS = 256
IPC_HEADER = 256  # bytes before the first staging buffer: the flags and the counts
IPC_ALIGN = 256  # each staging buffer starts on this
IPC_MAX_BLOCKS = 264  # blocks of a publish, and of a gather per rank (2 an SM)
IPC_MAX_WORLD = 64  # ranks a gather reads (the kernel's peer table)
RING_WAIT_S = 60.0  # a gather's bound on the wait for a peer (multihost's collective timeout)


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


# ---------------------------------------------------------------------------
# between processes on one card: the arithmetic, the plain version, the ring
# ---------------------------------------------------------------------------


def ipc_parity(epoch: int) -> int:
    """The staging buffer (and flag) of exchange ``epoch``: 0 or 1."""
    if epoch < 1:
        raise ValueError(f"exchanges count from 1, not {epoch}")
    return epoch % 2


def ipc_layout(stage_bytes: int) -> dict:
    """A rank's region for staging buffers of ``stage_bytes``: ``stride``
    (the bytes of one buffer, rounded up to IPC_ALIGN), ``flags`` (the byte
    offsets of flag 0 and 1, u64), ``counts`` (of the publish counts, u32),
    ``stages`` (of buffer 0 and 1) and ``bytes`` in all: the offsets that
    the launches pass to ``csrc/halo_ipc.cu``'s kernels, entry b for
    buffer b."""
    if stage_bytes < 1:
        raise ValueError(f"a staging buffer of {stage_bytes} bytes")
    stride = -(-stage_bytes // IPC_ALIGN) * IPC_ALIGN
    return dict(stride=stride, flags=(0, 8), counts=(16, 20),
                stages=(IPC_HEADER, IPC_HEADER + stride), bytes=IPC_HEADER + 2 * stride)


def ipc_plan(stage_bytes: int, ptrs) -> dict:
    """The kernels' launch for staging buffers of ``stage_bytes`` at base
    addresses ``ptrs`` (exports, pool): ``vec_bytes``, the widest of 16, 8,
    4, 2 that divides the bytes and every base (the regions' buffers start
    on IPC_ALIGN); ``words`` a rank; ``blocks`` of a publish and of a
    gather per rank, THREADS threads each, grid-striding past
    IPC_MAX_BLOCKS."""
    for v in (16, 8, 4, 2):
        if stage_bytes % v == 0 and all(x % v == 0 for x in ptrs):
            words = stage_bytes // v
            return dict(vec_bytes=v, words=words, threads=THREADS,
                        blocks=max(1, min(IPC_MAX_BLOCKS, -(-words // THREADS))))
    raise ValueError(f"no copy width for {stage_bytes} bytes")


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error {rc}")


def _release(lib, own: Optional[int], peers: List[int], word: Optional[int]) -> None:
    """Close the peers' mappings, free the own region and the error word
    (the ring's finalizer; return codes are not read: at exit the runtime
    may already be gone)."""
    if lib is None:
        return
    lib.halo_ipc_synchronize()
    for ptr in peers:
        lib.halo_ipc_close(ptr)
    if own is not None:
        lib.halo_ipc_free(own)
    if word is not None:
        lib.halo_ipc_free_error_word(word)


class IpcRing:
    """Kernel #15 between the processes of one group on one card: this
    rank's region, its peers' mapped regions, the exchange counter and the
    error word (the module docstring has the protocol).

    ``process_group``: the gloo group of the ranks (``world`` of them, this
    one ``rank``), every rank on ``device``.  The regions are allocated and
    their handles exchanged once, at the first ``publish`` (a collective of
    the group: every rank publishes the same exchanges), for that
    exchange's size; a larger exchange raises ``ValueError``.

    An exchange: ``e = begin()``, ``publish(exports, e)``, later ``pool =
    gather(e, shape)``.  ``launches`` of ``IPC_PUBLISH`` and ``IPC_GATHER``
    count the kernels."""

    def __init__(self, process_group, world: int, rank: int, device,
                 timeout_s: float = RING_WAIT_S) -> None:
        if not 1 <= world <= IPC_MAX_WORLD:
            raise ValueError(f"a ring of {world} ranks (at most {IPC_MAX_WORLD})")
        self.process_group, self.world, self.rank = process_group, world, rank
        self.device = torch.device(device)
        self.timeout_s = timeout_s
        self.epoch = 0
        self._layout: Optional[dict] = None  # ipc_layout of the regions, once allocated
        self._lib = None
        self._own: Optional[int] = None
        self._peers: List[int] = []  # mapped regions of the other ranks
        self._regions = None  # ctypes array: every rank's region, this process's addresses
        self._word: Optional[int] = None  # host address of the error word
        self._word_dev: Optional[int] = None
        self._finalizer = None
        # a list: every launch appends (kind, start, end) CUDA events around it
        self.events: Optional[list] = None

    # -- set-up -------------------------------------------------------------

    def _setup(self, stage_bytes: int) -> None:
        """Allocate the error word and this rank's region for staging
        buffers of ``stage_bytes``, and map every peer's: a collective of
        the group."""
        lib = IPC_PUBLISH.lib()
        self._lib = lib
        layout = ipc_layout(stage_bytes)
        with torch.cuda.device(self.device):
            host, devp = _P(), _P()
            _check(lib.halo_ipc_error_word(ctypes.byref(host), ctypes.byref(devp)),
                   "allocating the error word")
            self._word, self._word_dev = host.value, devp.value
            own = _P()
            _check(lib.halo_ipc_alloc(layout["bytes"], ctypes.byref(own)),
                   f"allocating a {layout['bytes']}-byte region")
            self._own = own.value
            self._finalizer = weakref.finalize(self, _release, lib, self._own, self._peers,
                                               self._word)
            nh = lib.halo_ipc_handle_bytes()
            handle = (ctypes.c_uint8 * nh)()
            _check(lib.halo_ipc_handle(self._own, handle), "cudaIpcGetMemHandle")
            mine = torch.tensor(bytearray(handle), dtype=torch.uint8)
            handles = torch.empty((self.world, nh), dtype=torch.uint8)
            dist.all_gather(list(handles.unbind(0)), mine, group=self.process_group)
            regions = []
            for q in range(self.world):
                if q == self.rank:
                    regions.append(self._own)
                    continue
                buf = (ctypes.c_uint8 * nh)(*handles[q].tolist())
                ptr = _P()
                _check(lib.halo_ipc_open(buf, ctypes.byref(ptr)),
                       f"cudaIpcOpenMemHandle of rank {q}'s region")
                self._peers.append(ptr.value)
                regions.append(ptr.value)
        self._regions = (_P * self.world)(*regions)
        self._layout = layout

    def close(self) -> None:
        """Wait for this rank's kernels and, over the group, for every
        rank's (a barrier), then unmap the peers and free the region and the
        error word; a collective of the group.  The ring is unusable after."""
        if self._finalizer is not None:
            self._finalizer.detach()
            self._finalizer = None
        if self._lib is None:
            return
        lib = self._lib
        with torch.cuda.device(self.device):
            _check(lib.halo_ipc_synchronize(), "synchronising before close")
            dist.barrier(group=self.process_group)
            for ptr in self._peers:
                _check(lib.halo_ipc_close(ptr), "cudaIpcCloseMemHandle")
            if self._own is not None:
                _check(lib.halo_ipc_free(self._own), "freeing the region")
            _check(lib.halo_ipc_free_error_word(self._word), "freeing the error word")
        self._peers, self._own, self._regions, self._layout = [], None, None, None
        self._word = self._word_dev = self._lib = None

    # -- the exchange -------------------------------------------------------

    @contextlib.contextmanager
    def _timed(self, kind: str):
        if self.events is None:
            yield
            return
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        yield
        ev[1].record()
        self.events.append((kind, *ev))

    def begin(self) -> int:
        """The next exchange's number (the counter of the group)."""
        self.epoch += 1
        return self.epoch

    def error(self) -> int:
        """The error word: 0, or ``(exchange << 16) | (rank + 1)`` of the
        first wait that passed its bound.  Read without a synchronisation:
        it shows the kernels that have ended."""
        if self._word is None:
            return 0
        return ctypes.c_uint64.from_address(self._word).value

    def raise_if_failed(self) -> None:
        word = self.error()
        if word:
            raise RuntimeError(
                f"halo ring: rank {self.rank} waited past {self.timeout_s} s for rank "
                f"{(word & 0xFFFF) - 1}'s exchange {word >> 16}; the peer died or fell behind")

    def publish(self, exports: torch.Tensor, epoch: int) -> None:
        """Copy ``exports`` [P_local, H, F] (float32 or bfloat16, contiguous,
        on the ring's card) into staging buffer ``ipc_parity(epoch)`` and set
        its flag to ``epoch``, on the current stream."""
        if exports.device.type != "cuda":
            raise ValueError(f"the ring between processes takes CUDA tensors, not {exports.device}")
        if exports.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"the kernel takes float32 or bfloat16, not {exports.dtype}")
        if exports.dim() != 3 or not exports.is_contiguous():
            raise ValueError("exports must be a contiguous [P_local, H, F] tensor")
        if epoch != self.epoch:
            raise ValueError(f"exchange {epoch} is not the current one ({self.epoch})")
        nbytes = exports.numel() * exports.element_size()
        if nbytes == 0:
            raise ValueError("empty exports")
        if self._layout is None:
            self._setup(nbytes)
        lay, b = self._layout, ipc_parity(epoch)
        if nbytes > lay["stride"]:
            raise ValueError(f"exports of {nbytes} bytes; the ring's buffers, made at its first "
                             f"exchange, hold {lay['stride']}")
        plan = ipc_plan(nbytes, (exports.data_ptr(),))
        stream = torch.cuda.current_stream(exports.device).cuda_stream
        with torch.cuda.device(exports.device), self._timed("publish"):
            rc = self._lib.halo_ipc_publish(plan["vec_bytes"], exports.data_ptr(), self._own,
                                            lay["flags"][b], lay["counts"][b], lay["stages"][b],
                                            epoch, plan["words"], plan["blocks"], THREADS, stream)
        _check(rc, "halo_ipc_publish launch")
        IPC_PUBLISH.launches += 1

    def gather(self, epoch: int, shape: tuple) -> torch.Tensor:
        """[world * P_local, H, F]: every rank's exports of exchange
        ``epoch``, rank order, once each rank's flag reads ``epoch``
        (``shape``: ``(P_local, H, F, dtype)`` of the exports, equal on
        every rank)."""
        if self._layout is None:
            raise RuntimeError("gather before any publish: the ring has no regions")
        self.raise_if_failed()
        p_local, h, f, dtype = shape
        pool = torch.empty((self.world * p_local, h, f), dtype=dtype, device=self.device)
        nbytes = p_local * h * f * pool.element_size()
        lay, b = self._layout, ipc_parity(epoch)
        if nbytes > lay["stride"]:
            raise ValueError(f"{nbytes} bytes a rank, the buffers hold {lay['stride']}")
        plan = ipc_plan(nbytes, (pool.data_ptr(),))
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with torch.cuda.device(self.device), self._timed("gather"):
            rc = self._lib.halo_ipc_gather(plan["vec_bytes"], self._regions, self.world,
                                           lay["flags"][b], lay["stages"][b], epoch,
                                           plan["words"], plan["blocks"], pool.data_ptr(),
                                           self._word_dev, int(self.timeout_s * 1e9), THREADS,
                                           stream)
        _check(rc, "halo_ipc_gather launch")
        IPC_GATHER.launches += 1
        return pool
