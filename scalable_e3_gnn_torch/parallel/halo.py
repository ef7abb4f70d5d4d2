"""Halo exchange and the dense partitioned SEGNN forward and train step.

Counterpart of the dense path of ``scalable_e3_gnn_tpu/parallel/halo.py``
(``exchange_halo``, ``_dense_geometry``, ``_local_attrs_dense``,
``_local_forward_dense``, ``shard_partitioned_dense``,
``make_dist_geometry_dense``, ``make_dist_forward_dense``,
``make_dist_train_step_dense``).  Per message-passing layer:

1. each partition exports its boundary rows (``h[boundary_idx]``, [H, F]);
2. the exports of all partitions are gathered into the boundary pool
   [P, H, F];
3. each partition fills its halo slots from the pool (``halo_map``) and runs
   ``SEGNNLayer.apply_dense_split`` on its interior and boundary blocks.

The JAX package runs one partition per device inside ``shard_map`` over a
mesh axis.  Here a ``PartitionGroup`` stands for that axis: all ``P``
partitions, the range ``[lo, hi)`` of them that this process owns, their
device and, when several processes share the partitions, the
``torch.distributed`` process group that joins them (``parallel.multihost``;
rank r owns a contiguous, rank-major range).  The runners hold the local
partitions as lists and step them layer by layer: the exchange, then each
partition's layer.

In one process, the gradients of the partitions meet in one autograd graph,
so the loss's backward already sums them (the JAX ``psum``).  Across
processes, every collective is an all-gather, which adds nothing, and the
sums are done afterwards in partition (or rank) order, so no collective
chooses an order:
- the exchange gathers the exports of every rank into the pool;
- its backward gathers every partition's cotangent pool and sums them in
  partition order, exactly as one process does, so the forward and the halo
  cotangents equal the one-process runner's bit for bit;
- the train step gathers the loss denominators and the per-partition losses,
  and the flat parameter gradients of every rank, summed in rank order, so
  every rank steps its optimizer on the same gradients and holds the same
  parameters and optimizer state, bit for bit.
The collectives are gloo's, which stages CUDA tensors through host memory
(the ranks may share one card).

Two exchange backends, as in JAX, which differ in how the pool is built:
- ``"all_gather"`` (JAX ``"xla"``, the default): the pool is the stack of
  the exports, in PyTorch (across processes, the process group's
  all-gather);
- ``"ring"`` (JAX ``"rdma"``): the pools built by kernel #15
  (``kernels.halo_ring``), one pool per partition, in one process only.
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
from ..kernels.halo_ring import ring_all_gather_fwd
from ..models.segnn import SEGNN
from ..utils.device import resolve_device
from .multihost import local_shard_slice, world_size_and_rank
from .partition import DensePartitionedGraph

__all__ = ["PartitionGroup", "DenseShard", "exchange_halo", "local_attrs_dense",
           "shard_partitioned_dense", "make_dist_geometry_dense", "make_dist_forward_dense",
           "make_dist_train_step_dense", "BACKENDS"]

BACKENDS = ("all_gather", "ring")
_RING_ACROSS_PROCESSES = (
    "the ring (#15) between processes needs CUDA IPC on one card or peer-mapped pools "
    "across cards, which the port does not have yet; use backend='all_gather'")


class PartitionGroup:
    """The partitions of the dense partitioned path (the JAX mesh axis
    ``"graph"``): ``num_parts`` in all, of which this process owns ``[lo,
    hi)``, on ``device`` (the current GPU unless given).

    Without ``process_group`` this process owns all of them.  With one
    (``torch.distributed.group.WORLD``, or a group of its own), its ranks
    share them: rank r owns the r-th contiguous range
    (``multihost.local_shard_slice``), and the exchange and the train step
    gather across its ranks.  Only gloo is supported: it stages a card's
    tensors through host memory, so ranks may share a card.  ``comm_seconds``
    adds up the host time spent in those collectives."""

    def __init__(self, num_parts: int, device=None, process_group=None) -> None:
        if num_parts < 1:
            raise ValueError(f"num_parts must be at least 1, not {num_parts}")
        self.num_parts = num_parts
        self.device = resolve_device(device)
        self.process_group = process_group
        self.world, self.rank = 1, 0
        if process_group is not None:
            backend = dist.get_backend(process_group)
            if backend != "gloo":
                raise NotImplementedError(
                    f"the {backend!r} backend: the partitioned path gathers through gloo only")
            self.world, self.rank = world_size_and_rank(process_group)
        self.lo, self.hi = local_shard_slice(num_parts, self.world, self.rank)
        self.comm_seconds = 0.0

    @property
    def num_local(self) -> int:
        return self.hi - self.lo

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[n, ...]`` of every rank -> ``[world * n, ...]`` in rank order (a
        0-d ``x``: ``[world]``), on ``x``'s device.  Gloo moves the elements
        as they are (no arithmetic); it takes CUDA tensors and stages them
        through host memory itself."""
        if self.world == 1:
            return x
        t0 = time.perf_counter()
        x = x.reshape(1) if x.dim() == 0 else x.contiguous()
        out = x.new_empty((self.world * x.shape[0], *x.shape[1:]))
        dist.all_gather(list(out.chunk(self.world)), x, group=self.process_group)
        self.comm_seconds += time.perf_counter() - t0
        return out


def _fold(rows) -> torch.Tensor:
    """rows[0] + rows[1] + ... , added in order (``rows`` may be an iterator:
    then one row at a time is held besides the sum)."""
    rows = iter(rows)
    acc = next(rows)
    for r in rows:
        acc = acc + r
    return acc


class DenseShard(NamedTuple):
    """One partition's arrays (the JAX shard tuple, in its order)."""

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


class _HaloExchange(torch.autograd.Function):
    """h_ext_p = [h_p ; pool_p[halo_map_p]], every pool_p the stacked exports
    ``h_q[boundary_idx_q]`` of every partition q: one shared pool (gathered
    across the group's ranks), or with ``ring`` partition p's own pool from
    kernel #15; the backward is the JAX ``_exchange_halo_xla_bwd``."""

    @staticmethod
    def forward(ctx, ring, group, bidx, hmap, *hs):
        f = hs[0].shape[-1]
        exports = torch.stack([h[b] for h, b in zip(hs, bidx)])  # [P_local, H, F]
        if ring:
            pools = ring_all_gather_fwd(exports).reshape(len(hs), -1, f)
        else:
            pool = exports if group is None else group.all_gather(exports)  # [P, H, F]
            pools = [pool.reshape(-1, f)] * len(hs)
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


def exchange_halo(hs: Sequence[torch.Tensor], boundary_idx: torch.Tensor,
                  halo_map: torch.Tensor, backend: str = "all_gather",
                  group: Optional[PartitionGroup] = None) -> List[torch.Tensor]:
    """Every local partition's extended features [Np + H, F]: its local rows,
    then its halo slots filled from the boundary pool.

    ``hs``: the local partitions' tensors [Np, F]; ``boundary_idx``,
    ``halo_map``: [P_local, H] (the partitions' export rows and the pool index
    of each halo slot).  ``backend``: ``"all_gather"`` (the JAX ``"xla"``) or
    ``"ring"`` (the JAX ``"rdma"``: kernel #15 on a CUDA tensor, one process
    only).  ``group``: the partitions' group when it spans several processes
    (``hs`` then holds only this rank's partitions); None in one process."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if group is not None and group.world == 1:
        group = None
    if backend == "ring" and group is not None:
        raise NotImplementedError(_RING_ACROSS_PROCESSES)
    return list(_HaloExchange.apply(backend == "ring", group, boundary_idx, halo_map, *hs))


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


def shard_partitioned_dense(part: DensePartitionedGraph,
                            group: PartitionGroup) -> List[DenseShard]:
    """The tensors of the group's local partitions ``[lo, hi)`` on its
    device, one ``DenseShard`` per partition (the JAX
    ``shard_partitioned_dense``).  ``part`` is the whole partitioned graph:
    every rank may build it from the same inputs and keep its own rows."""
    if part.num_parts != group.num_parts:
        raise ValueError(f"{part.num_parts} partitions for a group of {group.num_parts}")
    dev = group.device
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt).to(dev)
    return [DenseShard(
        nodes=t(part.nodes[p]), positions_ext=t(part.positions_ext[p]),
        node_mask=t(part.node_mask[p]), boundary_idx=t(part.boundary_idx[p], torch.int64),
        halo_map=t(part.halo_map[p], torch.int64), senders_int=t(part.senders_int[p]),
        mask_int=t(part.mask_int[p]), senders_bnd=t(part.senders_bnd[p]),
        mask_bnd=t(part.mask_bnd[p]), rev_int=t(part.rev_int[p]), rev_ext=t(part.rev_ext[p]))
        for p in range(group.lo, group.hi)]


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


class _DistDense(nn.Module):
    """The partitioned forward of ``model`` as a module, so a train step can
    run it on swapped-in parameters (``torch.func.functional_call``)."""

    def __init__(self, model: SEGNN, group: PartitionGroup, backend: str) -> None:
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
        self.model = model
        self.group = group
        self.backend = backend

    def forward(self, shards: Sequence[DenseShard], attrs=None) -> torch.Tensor:
        """[P_local, Np, F_out]: the local partitions' outputs, zero on their
        pad rows."""
        model = self.model
        _check_local(shards, self.group)
        if shards[0].nodes.device != model.device:
            raise ValueError(f"shards are on {shards[0].nodes.device}, model on {model.device}")
        if attrs is None:
            attrs = [local_attrs_dense(model, sh) for sh in shards]
        bidx = torch.stack([sh.boundary_idx for sh in shards])
        hmap = torch.stack([sh.halo_map for sh in shards])
        hs = []
        for sh, a in zip(shards, attrs):
            h = model.embed(sh.nodes, a[4])
            hs.append(torch.where(sh.node_mask[:, None], h, torch.zeros_like(h)))
        for layer in model.layers:
            h_ext = exchange_halo(hs, bidx, hmap, self.backend, self.group)
            hs = [layer.apply_dense_split(
                h, he, (sh.senders_int, a[0], a[1], sh.mask_int, sh.rev_int),
                (sh.senders_bnd, a[2], a[3], sh.mask_bnd, sh.rev_ext), a[4], sh.node_mask)
                for h, he, sh, a in zip(hs, h_ext, shards, attrs)]
        outs = []
        for h, sh, a in zip(hs, shards, attrs):
            out = model.head(model.pre_head(h, a[4]))
            outs.append(torch.where(sh.node_mask[:, None], out, torch.zeros_like(out)))
        return torch.stack(outs)


def _runner(model: SEGNN, group: PartitionGroup, backend: str) -> _DistDense:
    if backend == "ring" and group.world > 1:
        raise NotImplementedError(_RING_ACROSS_PROCESSES)
    return _DistDense(model, group, backend)


def make_dist_forward_dense(model: SEGNN, group: PartitionGroup,
                            backend: str = "all_gather") -> Callable:
    """``fwd(shards, attrs=None) -> [P_local, Np, F_out]``: the dense
    partitioned forward of the group's local partitions on the model's
    parameters (``attrs``: ``make_dist_geometry_dense``'s output, computed
    here when omitted)."""
    return _runner(model, group, backend)


def make_dist_train_step_dense(model: SEGNN, optimizer: torch.optim.Optimizer,
                               group: PartitionGroup, backend: str = "all_gather",
                               compute_dtype: Optional[torch.dtype] = None) -> Callable:
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
    through the casts, and the optimizer updates them."""
    runner = _runner(model, group, backend)
    params = [p for p in model.parameters() if p.requires_grad]
    multi = group.world > 1

    def step(shards: Sequence[DenseShard], targets: torch.Tensor, attrs=None):
        optimizer.zero_grad(set_to_none=True)
        if compute_dtype is not None:
            cast = {f"model.{nm}": w.to(compute_dtype) for nm, w in model.named_parameters()}
            out = torch.func.functional_call(runner, cast, (shards, attrs))
        else:
            out = runner(shards, attrs)
        masks = [sh.node_mask for sh in shards]
        count = sum(m.sum() for m in masks)
        if multi:
            count = group.all_gather(count).sum()
        denom = (torch.clamp(count, min=1) * targets.shape[-1]).to(targets.dtype)
        parts = []
        for o, t, m in zip(out.to(targets.dtype), targets, masks):
            err = (o - t) ** 2
            parts.append(torch.where(m[:, None], err, torch.zeros_like(err)).sum() / denom)
        loss = _fold(parts)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if multi:
            flat = group.all_gather(torch.cat([p.grad.reshape(-1) for p in params])[None])
            flat = _fold(flat)
            off = 0
            for p in params:
                p.grad.copy_(flat[off:off + p.numel()].view_as(p))
                off += p.numel()
            loss = _fold(group.all_gather(torch.stack(parts).detach()))
        optimizer.step()
        return {"loss": loss.detach()}

    return step
