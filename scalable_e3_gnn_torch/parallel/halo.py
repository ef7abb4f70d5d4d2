"""Halo exchange and the partitioned SEGNN forward and train step.

Counterpart of ``scalable_e3_gnn_tpu/parallel/halo.py`` on both of its
layouts: the COO one (``_edge_geometry``, ``_local_forward``,
``shard_partitioned``, ``make_dist_forward``, ``make_dist_train_step``) and
the fixed-degree one (``_dense_geometry``, ``_local_attrs_dense``,
``_local_forward_dense``, ``shard_partitioned_dense``,
``make_dist_geometry_dense``, ``make_dist_forward_dense``,
``make_dist_train_step_dense``), with ``exchange_halo`` and the data
parallelism over independent clouds of the train steps (JAX's ``dp_axis``).
Per message-passing layer:

1. each partition exports its boundary rows (``h[boundary_idx]``, [H, F]),
   and the gather of the exports of all partitions into the boundary pool
   [P, H, F] starts;
2. each partition runs the part of its layer that reads no halo: the
   interior receiver block (``SEGNNLayer.apply_dense_interior``) or the
   local edges (``SEGNNLayer.apply_split_local``);
3. the gather is waited on; each partition fills its halo slots from the
   pool (``halo_map``) and runs the rest of its layer: the boundary block or
   the remote edges, then the update.

So the exchange runs while the interior work does (JAX leaves that overlap
to XLA's scheduler).  ``_serialize_exchange=True`` (a private keyword of the
runners and train steps, JAX's A/B switch of ``_local_forward_dense``) waits
before step 2 instead; both give the same bits.

The JAX package runs one partition per device inside ``shard_map`` over a
mesh axis.  Here a ``PartitionGroup`` stands for that axis: all ``P``
partitions, the range ``[lo, hi)`` of them that this process owns, their
device and, when several processes share the partitions, the
``torch.distributed`` process group that joins them (``parallel.multihost``;
rank r owns a contiguous, rank-major range).  A ``CloudGroup`` stands for
the ``dp`` axis: ``D`` independent clouds, each partitioned the same way,
the range of them that this process owns and, across processes, the group
of every rank, laid out dp-major (rank = d * G + g for G graph ranks, as
JAX's ``(dp, graph)`` mesh); each dp row has a graph group of its own
(``multihost.dp_graph_group``).  The runners hold the local partitions as
lists and step them layer by layer.

In one process, the gradients of the partitions and clouds meet in one
autograd graph, so the loss's backward already sums them (the JAX
``psum``).  Across processes, every collective is an all-gather, which adds
nothing, and the sums are done afterwards in partition (or rank) order, so
no collective chooses an order:
- the exchange gathers the exports of every rank of the graph group into
  the pool;
- its backward gathers every partition's cotangent pool and sums them in
  partition order, exactly as one process does, so the forward and the halo
  cotangents equal the one-process runner's bit for bit;
- the train step gathers, over every rank, the loss denominators and the
  per-(cloud, partition) losses, added in (cloud, partition) order, and the
  flat parameter gradients, summed in rank order, so every rank steps its
  optimizer on the same gradients and holds the same parameters and
  optimizer state, bit for bit.
The collectives are gloo's, which stages CUDA tensors through host memory
(the ranks may share one card); the exchange's gather is asynchronous
(``async_op=True``), and at most one collective of a group is in flight.

Two exchange backends, as in JAX, which differ in how the pool is built:
- ``"all_gather"`` (JAX ``"xla"``, the default): the pool is the stack of
  the exports, in PyTorch (across processes, the process group's
  all-gather);
- ``"ring"`` (JAX ``"rdma"``): kernel #15 (``kernels.halo_ring``).  In one
  process one launch builds every partition's pool.  Across processes that
  share one card the group's ``IpcRing`` does: the publish kernel where the
  gather starts (step 1), the gather kernel where it is waited on (step 3),
  the pool the same bytes as the all-gather's.  The runners check at
  construction that the group's ranks share one card
  (``multihost.card_identities``; distinct cards raise
  ``NotImplementedError``), and read the ring's error word before every
  gather and, after a synchronisation of the stream, at the end of every
  forward (a peer that stopped publishing raises ``RuntimeError``, in a
  forward alone as in a train step); on CPU tensors the ring across
  processes is its plain version, the group's all-gather.
Both share one backward (``_HaloExchange``), the JAX
``_exchange_halo_xla_bwd``: the halo cotangents scattered into each
partition's pool, the reduce-scatter ``d_bound[p] = sum_q d_pool_q[p]`` in
partition order (the gradient of the ring's all-gather as well), then added
at ``boundary_idx``.
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..core.spherical import spherical_harmonics
from ..kernels.halo_ring import IpcRing, ring_all_gather_fwd
from ..models.segnn import SEGNN
from ..ops.gather_scatter import coo_edge_plans, segment_sum
from ..utils.device import resolve_device
from .multihost import card_identities, check_one_card, local_shard_slice, world_size_and_rank
from .partition import DensePartitionedGraph, PartitionedGraph

__all__ = ["PartitionGroup", "CloudGroup", "CooShard", "DenseShard", "exchange_halo",
           "local_attrs", "local_attrs_dense", "shard_partitioned", "shard_partitioned_dense",
           "make_dist_forward", "make_dist_train_step", "make_dist_geometry_dense",
           "make_dist_forward_dense", "make_dist_train_step_dense", "BACKENDS"]

BACKENDS = ("all_gather", "ring")


class _Ranks:
    """The ranks of a gloo process group (one process when None): all-gathers
    in rank order, and ``comm_seconds``, the host time spent in them (the
    synchronous calls whole; an asynchronous one's issue and its wait)."""

    def __init__(self, process_group=None) -> None:
        self.process_group = process_group
        self.world, self.rank = 1, 0
        if process_group is not None:
            backend = dist.get_backend(process_group)
            if backend != "gloo":
                raise NotImplementedError(
                    f"the {backend!r} backend: the partitioned path gathers through gloo only")
            self.world, self.rank = world_size_and_rank(process_group)
        self.comm_seconds = 0.0
        self._in_flight = False

    def _gather(self, x: torch.Tensor, async_op: bool):
        if self._in_flight:
            raise RuntimeError("a collective of this group is already in flight")
        t0 = time.perf_counter()
        x = x.reshape(1) if x.dim() == 0 else x.contiguous()
        out = x.new_empty((self.world * x.shape[0], *x.shape[1:]))
        work = dist.all_gather(list(out.chunk(self.world)), x, group=self.process_group,
                               async_op=async_op)
        self.comm_seconds += time.perf_counter() - t0
        return out, work

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[n, ...]`` of every rank -> ``[world * n, ...]`` in rank order (a
        0-d ``x``: ``[world]``), on ``x``'s device.  Gloo moves the elements
        as they are (no arithmetic); it takes CUDA tensors and stages them
        through host memory itself."""
        if self.world == 1:
            return x
        return self._gather(x, async_op=False)[0]

    def all_gather_start(self, x: torch.Tensor):
        """``all_gather`` started asynchronously: ``(out, work)``; ``out`` is
        valid (on the current stream) once ``wait(work)`` returned.  The
        caller keeps ``x`` alive and unmodified until then."""
        out, work = self._gather(x, async_op=True)
        self._in_flight = True
        return out, work

    def wait(self, work) -> None:
        t0 = time.perf_counter()
        try:
            work.wait()
        finally:
            self._in_flight = False
            self.comm_seconds += time.perf_counter() - t0


class PartitionGroup(_Ranks):
    """The partitions of a partitioned graph (the JAX mesh axis ``"graph"``):
    ``num_parts`` in all, of which this process owns ``[lo, hi)``, on
    ``device`` (the current GPU unless given).

    Without ``process_group`` this process owns all of them.  With one
    (``torch.distributed.group.WORLD``, or a group of its own, such as a dp
    row's), its ranks share them: rank r owns the r-th contiguous range
    (``multihost.local_shard_slice``), and the exchange (and, without a
    ``CloudGroup``, the train step) gathers across its ranks.  Only gloo is
    supported: it stages a card's tensors through host memory, so ranks may
    share a card.  ``comm_seconds`` adds up the host time spent in those
    collectives.  Under ``backend="ring"`` on a card the group holds one
    ``IpcRing`` (``ipc_ring``), shared by its runners; ``close`` frees it."""

    def __init__(self, num_parts: int, device=None, process_group=None) -> None:
        if num_parts < 1:
            raise ValueError(f"num_parts must be at least 1, not {num_parts}")
        super().__init__(process_group)
        self.num_parts = num_parts
        self.device = resolve_device(device)
        self.lo, self.hi = local_shard_slice(num_parts, self.world, self.rank)
        self._ring: Optional[IpcRing] = None

    @property
    def num_local(self) -> int:
        return self.hi - self.lo

    def ipc_ring(self) -> IpcRing:
        """The group's ring between processes, made at the first call after
        checking that every rank is on this rank's card (a collective of the
        group: ``NotImplementedError`` for distinct cards)."""
        if self._ring is None:
            check_one_card(card_identities(self.device, self.process_group))
            self._ring = IpcRing(self.process_group, self.world, self.rank, self.device)
        return self._ring

    def raise_if_exchange_failed(self) -> None:
        """``RuntimeError`` when a gather of the ring waited past its bound:
        waits for this rank's stream, so every gather launched on it has
        ended and written the error word, then reads the word."""
        if self._ring is not None:
            torch.cuda.current_stream(self.device).synchronize()
            self._ring.raise_if_failed()

    def close(self) -> None:
        """Free the ring's memory and handles (a collective of the group when
        it has a ring)."""
        if self._ring is not None:
            self._ring.close()
            self._ring = None


class CloudGroup(_Ranks):
    """The independent clouds of data parallelism (the JAX mesh axis
    ``dp``), each partitioned over ``group``'s partitions: ``num_clouds`` in
    all, of which this process owns ``[lo, hi)``.

    In one process (``process_group`` None) it owns all of them.  When
    ``group`` spans processes, ``process_group`` is the group of every rank
    (``torch.distributed.group.WORLD``), laid out dp-major: rank ``d * G +
    g`` is graph rank g of dp row d, for G = ``group.world``, and the rows
    share the clouds contiguously.  The train step gathers its denominator,
    losses and gradients over these ranks."""

    def __init__(self, num_clouds: int, group: PartitionGroup, process_group=None) -> None:
        if num_clouds < 1:
            raise ValueError(f"num_clouds must be at least 1, not {num_clouds}")
        if group.world > 1 and process_group is None:
            raise ValueError("the partitions span processes: give the group of every rank")
        super().__init__(process_group)
        if self.world % group.world:
            raise ValueError(f"{self.world} ranks are not rows of {group.world} graph ranks")
        self.num_clouds = num_clouds
        self.graph_ranks = group.world
        self.rows = self.world // group.world
        self.lo, self.hi = local_shard_slice(num_clouds, self.rows, self.rank // group.world)

    @property
    def num_local(self) -> int:
        return self.hi - self.lo

    def cloud_major(self, x: torch.Tensor) -> torch.Tensor:
        """Per-(cloud, partition) values gathered in rank order ([world *
        local clouds * local partitions]) -> (cloud, partition) order."""
        return x.view(self.rows, self.graph_ranks, self.num_local, -1).transpose(1, 2).reshape(-1)


def _fold(rows) -> torch.Tensor:
    """rows[0] + rows[1] + ... , added in order (``rows`` may be an iterator:
    then one row at a time is held besides the sum)."""
    rows = iter(rows)
    acc = next(rows)
    for r in rows:
        acc = acc + r
    return acc


class DenseShard(NamedTuple):
    """One partition's arrays of the dense layout (the JAX shard tuple, in
    its order)."""

    nodes: torch.Tensor  # [NI+NB, F]
    positions_ext: torch.Tensor  # [NI+NB+H, 3]
    node_mask: torch.Tensor  # [NI+NB] bool
    boundary_idx: torch.Tensor  # [H] int64
    halo_map: torch.Tensor  # [H] int64
    senders_int: torch.Tensor  # [NI, K] int32
    mask_int: torch.Tensor  # [NI, K] bool
    senders_bnd: torch.Tensor  # [NB, K] int32
    mask_bnd: torch.Tensor  # [NB, K] bool
    rev_int: torch.Tensor  # [NI+NB, Qi] int32
    rev_ext: torch.Tensor  # [NI+NB+H, Qb] int32


class CooShard(NamedTuple):
    """One partition's arrays of the COO layout (the JAX ``_shard_args``, in
    its order), then the segment plans of its two edge lists
    (``coo_shard_plans``; made by the runner when None)."""

    nodes: torch.Tensor  # [Np, F]
    positions_ext: torch.Tensor  # [Np+H, 3]
    node_mask: torch.Tensor  # [Np] bool
    boundary_idx: torch.Tensor  # [H] int64
    halo_map: torch.Tensor  # [H] int64
    senders_loc: torch.Tensor  # [El] int32, local rows; pad Np
    receivers_loc: torch.Tensor  # [El] int32, sorted; pad Np
    mask_loc: torch.Tensor  # [El] bool
    senders_rem: torch.Tensor  # [Er] int32, extended rows; pad Np+H
    receivers_rem: torch.Tensor  # [Er] int32, sorted; pad Np
    mask_rem: torch.Tensor  # [Er] bool
    plans: Optional[tuple] = None  # (local edges' plans, remote edges' plans)


class _HaloExchange(torch.autograd.Function):
    """h_ext_p = [h_p ; pools_p[halo_map_p]], every pool the stacked exports
    ``h_q[boundary_idx_q]`` of every partition q, already built (one shared
    pool, gathered across the group's ranks, or with ``ring`` partition p's
    own pool from kernel #15); the backward is the JAX
    ``_exchange_halo_xla_bwd``."""

    @staticmethod
    def forward(ctx, group, bidx, hmap, pools, *hs):
        ctx.save_for_backward(bidx, hmap)
        ctx.group = group
        ctx.npp = [h.shape[0] for h in hs]
        return tuple(torch.cat([h, pool[m]]) for h, pool, m in zip(hs, pools, hmap))

    @staticmethod
    def backward(ctx, *d_ext):
        bidx, hmap = ctx.saved_tensors
        group = ctx.group
        hcap = bidx.shape[1]
        p = bidx.shape[0] if group is None else group.num_parts
        lo = 0 if group is None else group.lo
        f = d_ext[0].shape[-1]
        # each partition's halo cotangents into its own [P*H, F] pool, then
        # the reduce-scatter: d_bound[q] = sum over partitions of their pool's
        # slice q, summed in partition order (in one process a running sum;
        # across processes every partition's pool is gathered first)
        d_pools = (d.new_zeros((p * hcap, f)).index_add_(0, m, d[npp:])
                   for d, m, npp in zip(d_ext, hmap, ctx.npp))
        if group is None:
            d_bound = _fold(d_pools)
        else:
            d_pools = group.all_gather(torch.stack(list(d_pools)))
            d_bound = _fold(d_pools[:, lo * hcap:(lo + len(d_ext)) * hcap])
        d_bound = d_bound.view(len(d_ext), hcap, f)
        d_local = [d[:npp].clone().index_add_(0, b, db)
                   for d, b, db, npp in zip(d_ext, bidx, d_bound, ctx.npp)]
        return (None, None, None, None, *d_local)


class _Exchange:
    """One layer's halo exchange, started: the exports of the local
    partitions (detached: the exchange's gradient is ``_HaloExchange``'s) and
    their pools, built at once in one process, or across processes the
    ring's publish launched (``backend="ring"`` on a card) or the group's
    asynchronous all-gather in flight.  ``wait`` ends the gather (the ring's
    gather kernel); ``finish`` waits, then builds every partition's extended
    features."""

    def __init__(self, hs, bidx, hmap, backend: str, group: Optional[PartitionGroup]) -> None:
        self.bidx, self.hmap, self.group, self.n = bidx, hmap, group, len(hs)
        exports = torch.stack([h.detach()[b] for h, b in zip(hs, bidx)])  # [P_local, H, F]
        self.f = exports.shape[-1]
        self.work = self.ring = None
        if group is None:
            if backend == "ring":
                self.pools = tuple(ring_all_gather_fwd(exports).reshape(self.n, -1, self.f))
            else:
                self.pools = (exports.reshape(-1, self.f),) * self.n
        elif backend == "ring" and exports.device.type == "cuda":
            self.ring = group.ipc_ring()
            self.epoch = self.ring.begin()
            self.ring.publish(exports, self.epoch)
            self.shape = (*exports.shape, exports.dtype)
        else:
            # the exports stay referenced until the gather is waited on
            self.exports = exports
            self.pool, self.work = group.all_gather_start(exports)

    def wait(self) -> None:
        if self.ring is not None:
            pool = self.ring.gather(self.epoch, self.shape)
            self.ring = None
            self.pools = (pool.reshape(-1, self.f),) * self.n
        elif self.work is not None:
            self.group.wait(self.work)
            self.work, self.exports = None, None
            self.pools = (self.pool.reshape(-1, self.f),) * self.n

    def finish(self, hs) -> List[torch.Tensor]:
        self.wait()
        return list(_HaloExchange.apply(self.group, self.bidx, self.hmap, self.pools, *hs))


def _exchange_group(backend: str, group: Optional[PartitionGroup]) -> Optional[PartitionGroup]:
    """The group an exchange gathers over: None in one process.  The ring
    across processes on a card makes the group's ``IpcRing`` here, which
    checks that the ranks share the card."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if group is not None and group.world == 1:
        group = None
    if backend == "ring" and group is not None and group.device.type == "cuda":
        group.ipc_ring()
    return group


def exchange_halo(hs: Sequence[torch.Tensor], boundary_idx: torch.Tensor,
                  halo_map: torch.Tensor, backend: str = "all_gather",
                  group: Optional[PartitionGroup] = None) -> List[torch.Tensor]:
    """Every local partition's extended features [Np + H, F]: its local rows,
    then its halo slots filled from the boundary pool.

    ``hs``: the local partitions' tensors [Np, F]; ``boundary_idx``,
    ``halo_map``: [P_local, H] (the partitions' export rows and the pool index
    of each halo slot).  ``backend``: ``"all_gather"`` (the JAX ``"xla"``) or
    ``"ring"`` (the JAX ``"rdma"``: kernel #15 on a CUDA tensor; across
    processes the group's ``IpcRing``, its ranks on one card).  ``group``:
    the partitions' group when it spans several processes (``hs`` then holds
    only this rank's partitions); None in one process."""
    group = _exchange_group(backend, group)
    return _Exchange(hs, boundary_idx, halo_map, backend, group).finish(hs)


def _dense_geometry(model: SEGNN, pos_src, pos_r, senders, mask):
    """[Nb, K] slot geometry: sh attributes and squared distances (both zero
    on masked slots)."""
    xs = pos_src[torch.clamp(senders, max=pos_src.shape[0] - 1).long()]
    rel = xs - pos_r[:, None, :]
    rel = torch.where(mask[..., None], rel, torch.zeros_like(rel))
    dist2 = torch.sum(rel * rel, dim=-1)
    attr = spherical_harmonics(model.lmax_attr, rel)
    return torch.where(mask[..., None], attr, torch.zeros_like(attr)), dist2


def local_attrs_dense(model: SEGNN, shard: DenseShard):
    """(attr_int, d2_int, attr_bnd, d2_bnd, node_attr) of one partition:
    geometry only, graph constants.  A node's attribute is the mean of its
    incident slot attributes (the two blocks partition the rows), with the
    scalar channel set to 1, as ``SEGNN.compute_attributes_dense``."""
    npp = shard.nodes.shape[0]
    ni = shard.senders_int.shape[0]
    pos_local = shard.positions_ext[:npp]
    attr_i, d2_i = _dense_geometry(model, pos_local, pos_local[:ni], shard.senders_int,
                                   shard.mask_int)
    attr_b, d2_b = _dense_geometry(model, shard.positions_ext, pos_local[ni:],
                                   shard.senders_bnd, shard.mask_bnd)
    cnt_i = torch.clamp(shard.mask_int.sum(dim=1), min=1)
    cnt_b = torch.clamp(shard.mask_bnd.sum(dim=1), min=1)
    node_attr = torch.cat([attr_i.sum(dim=1) / cnt_i[:, None].to(attr_i.dtype),
                           attr_b.sum(dim=1) / cnt_b[:, None].to(attr_b.dtype)])
    node_attr[..., 0] = 1.0
    return attr_i, d2_i, attr_b, d2_b, node_attr


def _edge_geometry(model: SEGNN, pos_ext, npp: int, senders, receivers, mask):
    """[E] edge geometry of one edge list: sh attributes of ``x_s - x_r``
    (senders clipped into the extended rows, receivers into the local ones)
    and squared distances, both zero on masked edges."""
    s = torch.clamp(senders.long(), max=pos_ext.shape[0] - 1)
    r = torch.clamp(receivers.long(), max=npp - 1)
    rel = pos_ext[s] - pos_ext[r]
    rel = torch.where(mask[:, None], rel, torch.zeros_like(rel))
    dist2 = torch.sum(rel * rel, dim=-1)
    attr = spherical_harmonics(model.lmax_attr, rel)
    return torch.where(mask[:, None], attr, torch.zeros_like(attr)), dist2


def local_attrs(model: SEGNN, shard: CooShard, velocities=None):
    """(attr_loc, d2_loc, attr_rem, d2_rem, node_attr) of one COO partition:
    a node's attribute is the mean of the attributes of its incident edges
    over both lists, plus sh(v) under ``vel_attr`` when ``velocities`` [Np,
    3] are given, the scalar channel then set to 1 (the JAX
    ``_local_forward``)."""
    npp = shard.nodes.shape[0]
    pos = shard.positions_ext
    attr_l, d2_l = _edge_geometry(model, pos, npp, shard.senders_loc, shard.receivers_loc,
                                  shard.mask_loc)
    attr_r, d2_r = _edge_geometry(model, pos, npp, shard.senders_rem, shard.receivers_rem,
                                  shard.mask_rem)
    ids_l = torch.where(shard.mask_loc, shard.receivers_loc.long(), npp)
    ids_r = torch.where(shard.mask_rem, shard.receivers_rem.long(), npp)
    ssum = segment_sum(attr_l, ids_l, npp) + segment_sum(attr_r, ids_r, npp)
    cnt = (segment_sum(shard.mask_loc.to(attr_l.dtype), ids_l, npp)
           + segment_sum(shard.mask_rem.to(attr_l.dtype), ids_r, npp))
    node_attr = ssum / torch.clamp(cnt, min=1e-9)[:, None]
    if model.vel_attr and velocities is not None:
        node_attr = node_attr + spherical_harmonics(model.lmax_attr, velocities)
    node_attr = torch.cat([torch.ones_like(node_attr[:, :1]), node_attr[:, 1:]], dim=-1)
    return attr_l, d2_l, attr_r, d2_r, node_attr


def coo_shard_plans(shard: CooShard) -> tuple:
    """The ``coo_edge_plans`` of a COO partition's local edges (senders into
    its rows) and remote edges (senders into its extended rows)."""
    npp = shard.nodes.shape[0]
    return (coo_edge_plans(shard.senders_loc, shard.receivers_loc, npp, npp),
            coo_edge_plans(shard.senders_rem, shard.receivers_rem, npp,
                           shard.positions_ext.shape[0]))


def _check_parts(part, group: PartitionGroup) -> None:
    if part.num_parts != group.num_parts:
        raise ValueError(f"{part.num_parts} partitions for a group of {group.num_parts}")


def shard_partitioned_dense(part: DensePartitionedGraph,
                            group: PartitionGroup) -> List[DenseShard]:
    """The tensors of the group's local partitions ``[lo, hi)`` on its
    device, one ``DenseShard`` per partition (the JAX
    ``shard_partitioned_dense``).  ``part`` is the whole partitioned graph:
    every rank may build it from the same inputs and keep its own rows."""
    _check_parts(part, group)
    dev = group.device
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt).to(dev)
    return [DenseShard(
        nodes=t(part.nodes[p]), positions_ext=t(part.positions_ext[p]),
        node_mask=t(part.node_mask[p]), boundary_idx=t(part.boundary_idx[p], torch.int64),
        halo_map=t(part.halo_map[p], torch.int64), senders_int=t(part.senders_int[p]),
        mask_int=t(part.mask_int[p]), senders_bnd=t(part.senders_bnd[p]),
        mask_bnd=t(part.mask_bnd[p]), rev_int=t(part.rev_int[p]), rev_ext=t(part.rev_ext[p]))
        for p in range(group.lo, group.hi)]


def shard_partitioned(part: PartitionedGraph, group: PartitionGroup) -> List[CooShard]:
    """The tensors of the group's local COO partitions ``[lo, hi)`` on its
    device, one ``CooShard`` per partition with its segment plans (the JAX
    ``shard_partitioned``)."""
    _check_parts(part, group)
    dev = group.device
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt).to(dev)
    shards = [CooShard(
        nodes=t(part.nodes[p]), positions_ext=t(part.positions_ext[p]),
        node_mask=t(part.node_mask[p]), boundary_idx=t(part.boundary_idx[p], torch.int64),
        halo_map=t(part.halo_map[p], torch.int64), senders_loc=t(part.senders_loc[p]),
        receivers_loc=t(part.receivers_loc[p]), mask_loc=t(part.mask_loc[p]),
        senders_rem=t(part.senders_rem[p]), receivers_rem=t(part.receivers_rem[p]),
        mask_rem=t(part.mask_rem[p])) for p in range(group.lo, group.hi)]
    return [sh._replace(plans=coo_shard_plans(sh)) for sh in shards]


def _check_local(shards, group: PartitionGroup) -> None:
    if len(shards) != group.num_local:
        raise ValueError(f"{len(shards)} shards for a group that owns {group.num_local} "
                         f"of {group.num_parts} partitions")


def make_dist_geometry_dense(model: SEGNN, group: PartitionGroup) -> Callable:
    """``geo(shards) -> [local_attrs_dense(model, shard) per local partition]``:
    computed once per graph and passed as ``attrs`` to the forward and the
    train step, it keeps the sh embedding out of the step."""

    def geo(shards: Sequence[DenseShard]):
        _check_local(shards, group)
        with torch.no_grad():
            return [local_attrs_dense(model, sh) for sh in shards]

    return geo


class _DistRunner(nn.Module):
    """The partitioned forward of ``model`` on one cloud as a module, so a
    train step can run it on swapped-in parameters
    (``torch.func.functional_call``)."""

    def __init__(self, model: SEGNN, group: PartitionGroup, backend: str,
                 serialize: bool) -> None:
        super().__init__()
        self.model = model
        self.group = group
        self.backend = backend
        self.exchange_group = _exchange_group(backend, group)
        self.serialize = serialize

    def _check(self, shards) -> None:
        _check_local(shards, self.group)
        if shards[0].nodes.device != self.model.device:
            raise ValueError(f"shards are on {shards[0].nodes.device}, model on "
                             f"{self.model.device}")

    def _run(self, shards, node_attrs, first: Callable, second: Callable) -> torch.Tensor:
        """[P_local, Np, F_out]: the embed, then per layer the exchange
        started, ``first(layer, p, h)`` of every local partition (the halves
        that read no halo), the exchange finished, ``second(layer, p, h,
        h_ext, first's result)``; then the head, zero on pad rows."""
        model = self.model
        bidx = torch.stack([sh.boundary_idx for sh in shards])
        hmap = torch.stack([sh.halo_map for sh in shards])
        hs = []
        for sh, na in zip(shards, node_attrs):
            h = model.embed(sh.nodes, na)
            hs.append(torch.where(sh.node_mask[:, None], h, torch.zeros_like(h)))
        for layer in model.layers:
            ex = _Exchange(hs, bidx, hmap, self.backend, self.exchange_group)
            if self.serialize:
                ex.wait()
            firsts = [first(layer, p, h) for p, h in enumerate(hs)]
            h_ext = ex.finish(hs)
            hs = [second(layer, p, h, he, a)
                  for p, (h, he, a) in enumerate(zip(hs, h_ext, firsts))]
        outs = []
        for h, sh, na in zip(hs, shards, node_attrs):
            out = model.head(model.pre_head(h, na))
            outs.append(torch.where(sh.node_mask[:, None], out, torch.zeros_like(out)))
        if self.exchange_group is not None:
            # a gather that gave up on a peer left NaN in its pool: raise here
            self.exchange_group.raise_if_exchange_failed()
        return torch.stack(outs)


class _DistDense(_DistRunner):
    def forward(self, shards: Sequence[DenseShard], attrs=None) -> torch.Tensor:
        """[P_local, Np, F_out]: the local partitions' outputs, zero on their
        pad rows."""
        self._check(shards)
        if attrs is None:
            attrs = [local_attrs_dense(self.model, sh) for sh in shards]
        first = lambda layer, p, h: layer.apply_dense_interior(
            h, (shards[p].senders_int, attrs[p][0], attrs[p][1], shards[p].mask_int,
                shards[p].rev_int))
        second = lambda layer, p, h, he, agg: layer.apply_dense_boundary(
            h, he, agg, (shards[p].senders_bnd, attrs[p][2], attrs[p][3], shards[p].mask_bnd,
                         shards[p].rev_ext), attrs[p][4], shards[p].node_mask)
        return self._run(shards, [a[4] for a in attrs], first, second)


class _DistCoo(_DistRunner):
    def forward(self, shards: Sequence[CooShard], velocities=None) -> torch.Tensor:
        """[P_local, Np, F_out]: the local partitions' outputs, zero on their
        pad rows; ``velocities``: [P_local, Np, 3] (or a list), read under
        ``vel_attr``."""
        self._check(shards)
        vel = [None] * len(shards) if velocities is None else velocities
        attrs = [local_attrs(self.model, sh, v) for sh, v in zip(shards, vel)]
        plans = [sh.plans if sh.plans is not None else coo_shard_plans(sh) for sh in shards]
        first = lambda layer, p, h: layer.apply_split_local(
            h, (shards[p].senders_loc, shards[p].receivers_loc, shards[p].mask_loc,
                attrs[p][0], attrs[p][1]), plans[p][0])
        second = lambda layer, p, h, he, agg: layer.apply_split_remote(
            h, he, agg, (shards[p].senders_rem, shards[p].receivers_rem, shards[p].mask_rem,
                         attrs[p][2], attrs[p][3]), attrs[p][4], shards[p].node_mask,
            plans[p][1])
        return self._run(shards, [a[4] for a in attrs], first, second)


def make_dist_forward_dense(model: SEGNN, group: PartitionGroup, backend: str = "all_gather",
                            _serialize_exchange: bool = False) -> Callable:
    """``fwd(shards, attrs=None) -> [P_local, Np, F_out]``: the dense
    partitioned forward of the group's local partitions on the model's
    parameters (``attrs``: ``make_dist_geometry_dense``'s output, computed
    here when omitted)."""
    return _DistDense(model, group, backend, _serialize_exchange)


def make_dist_forward(model: SEGNN, group: PartitionGroup, backend: str = "all_gather",
                      _serialize_exchange: bool = False) -> Callable:
    """``fwd(shards, velocities=None) -> [P_local, Np, F_out]``: the COO
    partitioned forward of the group's local partitions (``CooShard``s) on
    the model's parameters, the edge geometry computed from the shards (as
    the JAX ``make_dist_forward``)."""
    return _DistCoo(model, group, backend, _serialize_exchange)


def _train_step(runner: _DistRunner, optimizer: torch.optim.Optimizer,
                dp: Optional[CloudGroup], compute_dtype: Optional[torch.dtype]) -> Callable:
    """The train step shared by both layouts: ``step(shards, targets,
    extra=None)`` runs ``runner(shards_c, extra_c)`` for each local cloud c
    (one without ``dp``), the masked squared error of each (cloud,
    partition) over the global ``sum(node_mask) * F_out``, their sum in
    (cloud, partition) order, its backward, across processes the gathers
    and ordered sums, and ``optimizer.step()``."""
    model, group = runner.model, runner.group
    if dp is not None and dp.graph_ranks != group.world:
        raise ValueError(f"a CloudGroup of {dp.graph_ranks} graph ranks for a group of "
                         f"{group.world}")
    ranks = dp if dp is not None else group
    multi = ranks.world > 1
    params = [p for p in model.parameters() if p.requires_grad]

    def step(shards, targets: torch.Tensor, extra=None):
        if dp is None:
            shards, targets, extra = [shards], targets[None], [extra]
        elif len(shards) != dp.num_local:
            raise ValueError(f"{len(shards)} clouds for a CloudGroup that owns {dp.num_local}")
        if extra is None:
            extra = [None] * len(shards)
        optimizer.zero_grad(set_to_none=True)
        if compute_dtype is not None:
            cast = {f"model.{nm}": w.to(compute_dtype) for nm, w in model.named_parameters()}
            outs = [torch.func.functional_call(runner, cast, (s, e))
                    for s, e in zip(shards, extra)]
        else:
            outs = [runner(s, e) for s, e in zip(shards, extra)]
        masks = [[sh.node_mask for sh in s] for s in shards]
        count = sum(m.sum() for ms in masks for m in ms)
        if multi:
            count = ranks.all_gather(count).sum()
        denom = (torch.clamp(count, min=1) * targets.shape[-1]).to(targets.dtype)
        parts = []
        for out, tgt, ms in zip(outs, targets, masks):
            for o, t, m in zip(out.to(targets.dtype), tgt, ms):
                err = (o - t) ** 2
                parts.append(torch.where(m[:, None], err, torch.zeros_like(err)).sum() / denom)
        loss = _fold(parts)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if multi:
            flat = ranks.all_gather(torch.cat([p.grad.reshape(-1) for p in params])[None])
            flat = _fold(flat)
            off = 0
            for p in params:
                p.grad.copy_(flat[off:off + p.numel()].view_as(p))
                off += p.numel()
            gathered = ranks.all_gather(torch.stack(parts).detach())
            loss = _fold(dp.cloud_major(gathered) if dp is not None else gathered)
        optimizer.step()
        return {"loss": loss.detach()}

    return step


def make_dist_train_step_dense(model: SEGNN, optimizer: torch.optim.Optimizer,
                               group: PartitionGroup, backend: str = "all_gather",
                               compute_dtype: Optional[torch.dtype] = None,
                               dp: Optional[CloudGroup] = None,
                               _serialize_exchange: bool = False) -> Callable:
    """``step(shards, targets, attrs=None) -> {"loss"}``: the dense
    partitioned train step on the group's local partitions, updating
    ``model``'s parameters in place.

    ``targets`` [P_local, Np, F_out] in partition-local row order
    (``target[global_ids]`` of the local partitions, pad rows anything: they
    are masked).  The loss is the squared error over the real rows of every
    partition, each partition's sum divided by the global ``sum(node_mask) *
    F_out`` and the partitions added in order; every rank reports the whole
    loss.  Across processes the denominator is gathered over the ranks (the
    JAX ``psum``), and the parameter gradients of every rank are summed in
    rank order before ``optimizer.step()`` (the JAX ``psum(grads)``), so the
    ranks' parameters and optimizer states stay equal bit for bit.
    ``compute_dtype``: the forward runs on copies of the parameters in that
    dtype (bf16 compute on fp32 masters); the gradients reach the masters
    through the casts, and the optimizer updates them.  ``dp`` (the JAX
    ``dp_axis``): the step takes the ``dp.num_local`` local clouds, shards
    nested ``[cloud][partition]``, ``targets`` [D_local, P_local, Np, F_out]
    and ``attrs`` one list per cloud (or None); the denominator counts every
    cloud's rows, and the per-(cloud, partition) losses add in (cloud,
    partition) order."""
    return _train_step(_DistDense(model, group, backend, _serialize_exchange), optimizer, dp,
                       compute_dtype)


def make_dist_train_step(model: SEGNN, optimizer: torch.optim.Optimizer, group: PartitionGroup,
                         backend: str = "all_gather", dp: Optional[CloudGroup] = None,
                         _serialize_exchange: bool = False) -> Callable:
    """``step(shards, targets) -> {"loss"}``: the COO partitioned train step
    (the JAX ``make_dist_train_step``), the loss, the gradient sums and
    ``dp`` as ``make_dist_train_step_dense``'s, in fp32 (as in JAX, no
    compute dtype)."""
    step = _train_step(_DistCoo(model, group, backend, _serialize_exchange), optimizer, dp, None)
    return lambda shards, targets: step(shards, targets)
