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
mesh axis.  Here a ``PartitionGroup`` stands for that axis: the partitions
this process owns and their device.  In this module all P partitions live on
one device (a card, or the CPU), the runners hold them as lists, and step
them layer by layer: the exchange, then each partition's layer.  The
gradients of the partitions meet in one autograd graph, so the loss's
backward already sums them over the partitions (the JAX ``psum``).

Two exchange backends, as in JAX, which differ in how the pool is built:
- ``"all_gather"`` (JAX ``"xla"``, the default): the pool is the stack of
  the exports, in PyTorch;
- ``"ring"`` (JAX ``"rdma"``): the pools built by kernel #15
  (``kernels.halo_ring``), one pool per partition.
Both share one backward (``_HaloExchange``), the JAX
``_exchange_halo_xla_bwd``: the halo cotangents scattered into each
partition's pool, the reduce-scatter ``d_bound[p] = sum_q d_pool_q[p]`` in
partition order (the gradient of the ring's all-gather as well), then added
at ``boundary_idx``.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import torch
from torch import nn

from ..core.spherical import spherical_harmonics
from ..kernels.halo_ring import ring_all_gather_fwd
from ..models.segnn import SEGNN
from ..utils.device import resolve_device
from .partition import DensePartitionedGraph

__all__ = ["PartitionGroup", "DenseShard", "exchange_halo", "local_attrs_dense",
           "shard_partitioned_dense", "make_dist_geometry_dense", "make_dist_forward_dense",
           "make_dist_train_step_dense", "BACKENDS"]

BACKENDS = ("all_gather", "ring")


class PartitionGroup:
    """The partitions of the dense partitioned path that this process owns,
    and their device (the JAX mesh axis ``"graph"``): all ``num_parts`` on
    ``device``, the current GPU unless given."""

    def __init__(self, num_parts: int, device=None) -> None:
        if num_parts < 1:
            raise ValueError(f"num_parts must be at least 1, not {num_parts}")
        self.num_parts = num_parts
        self.device = resolve_device(device)


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
    ``h_q[boundary_idx_q]`` of every partition q: one shared pool, or with
    ``ring`` partition p's own pool from kernel #15; the backward is the JAX
    ``_exchange_halo_xla_bwd``."""

    @staticmethod
    def forward(ctx, ring, bidx, hmap, *hs):
        p, f = len(hs), hs[0].shape[-1]
        exports = torch.stack([h[b] for h, b in zip(hs, bidx)])  # [P, H, F]
        if ring:
            pools = ring_all_gather_fwd(exports).reshape(p, -1, f)
        else:
            pools = [exports.reshape(-1, f)] * p
        ctx.save_for_backward(bidx, hmap)
        ctx.npp = [h.shape[0] for h in hs]
        return tuple(torch.cat([h, pool[m]]) for h, pool, m in zip(hs, pools, hmap))

    @staticmethod
    def backward(ctx, *d_ext):
        bidx, hmap = ctx.saved_tensors
        p, hcap = bidx.shape
        f = d_ext[0].shape[-1]
        # each partition's halo cotangents into its own [P*H, F] pool, then
        # the reduce-scatter: d_bound[q] = sum over partitions of their pool's
        # slice q, summed in partition order
        d_bound = None
        for d, m, npp in zip(d_ext, hmap, ctx.npp):
            d_pool = d.new_zeros((p * hcap, f)).index_add_(0, m, d[npp:])
            d_bound = d_pool if d_bound is None else d_bound + d_pool
        d_bound = d_bound.view(p, hcap, f)
        d_local = [d[:npp].clone().index_add_(0, b, db)
                   for d, b, db, npp in zip(d_ext, bidx, d_bound, ctx.npp)]
        return (None, None, None, *d_local)


def exchange_halo(hs: Sequence[torch.Tensor], boundary_idx: torch.Tensor,
                  halo_map: torch.Tensor, backend: str = "all_gather") -> List[torch.Tensor]:
    """Every partition's extended features [Np + H, F]: its local rows, then
    its halo slots filled from the boundary pool.

    ``hs``: P tensors [Np, F]; ``boundary_idx``, ``halo_map``: [P, H] (the
    partitions' export rows and the pool index of each halo slot).
    ``backend``: ``"all_gather"`` (the JAX ``"xla"``) or ``"ring"`` (the JAX
    ``"rdma"``: kernel #15 on a CUDA tensor)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    return list(_HaloExchange.apply(backend == "ring", boundary_idx, halo_map, *hs))


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
    """Per-partition tensors on the group's device, one ``DenseShard`` per
    partition (the JAX ``shard_partitioned_dense``)."""
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
        for p in range(part.num_parts)]


def make_dist_geometry_dense(model: SEGNN, group: PartitionGroup) -> Callable:
    """``geo(shards) -> [local_attrs_dense(model, shard) per partition]``:
    computed once per graph and passed as ``attrs`` to the forward and the
    train step, it keeps the sh embedding out of the step."""

    def geo(shards: Sequence[DenseShard]):
        if len(shards) != group.num_parts:
            raise ValueError(f"{len(shards)} shards for a group of {group.num_parts}")
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
        """[P, Np, F_out]: every partition's outputs, zero on its pad rows."""
        model = self.model
        if len(shards) != self.group.num_parts:
            raise ValueError(f"{len(shards)} shards for a group of {self.group.num_parts}")
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
            h_ext = exchange_halo(hs, bidx, hmap, self.backend)
            hs = [layer.apply_dense_split(
                h, he, (sh.senders_int, a[0], a[1], sh.mask_int, sh.rev_int),
                (sh.senders_bnd, a[2], a[3], sh.mask_bnd, sh.rev_ext), a[4], sh.node_mask)
                for h, he, sh, a in zip(hs, h_ext, shards, attrs)]
        outs = []
        for h, sh, a in zip(hs, shards, attrs):
            out = model.head(model.pre_head(h, a[4]))
            outs.append(torch.where(sh.node_mask[:, None], out, torch.zeros_like(out)))
        return torch.stack(outs)


def make_dist_forward_dense(model: SEGNN, group: PartitionGroup,
                            backend: str = "all_gather") -> Callable:
    """``fwd(shards, attrs=None) -> [P, Np, F_out]``: the dense partitioned
    forward on the model's parameters (``attrs``: ``make_dist_geometry_dense``'s
    output, computed here when omitted)."""
    return _DistDense(model, group, backend)


def make_dist_train_step_dense(model: SEGNN, optimizer: torch.optim.Optimizer,
                               group: PartitionGroup, backend: str = "all_gather",
                               compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """``step(shards, targets, attrs=None) -> {"loss"}``: the dense
    partitioned train step, updating ``model``'s parameters in place.

    ``targets`` [P, Np, F_out] in partition-local row order
    (``target[global_ids]``, pad rows anything: they are masked).  The loss is
    the squared error over the real rows of every partition, each partition's
    sum divided by the global ``sum(node_mask) * F_out`` and the partitions
    added in order.  ``compute_dtype``: the forward runs on copies of the
    parameters in that dtype (bf16 compute on fp32 masters); the gradients
    reach the masters through the casts, and the optimizer updates them."""
    dist = _DistDense(model, group, backend)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(shards: Sequence[DenseShard], targets: torch.Tensor, attrs=None):
        optimizer.zero_grad(set_to_none=True)
        if compute_dtype is not None:
            cast = {f"model.{nm}": w.to(compute_dtype) for nm, w in model.named_parameters()}
            out = torch.func.functional_call(dist, cast, (shards, attrs))
        else:
            out = dist(shards, attrs)
        masks = [sh.node_mask for sh in shards]
        denom = torch.clamp(sum(m.sum() for m in masks), min=1) * targets.shape[-1]
        denom = denom.to(targets.dtype)
        loss = None
        for o, t, m in zip(out.to(targets.dtype), targets, masks):
            err = (o - t) ** 2
            part = torch.where(m[:, None], err, torch.zeros_like(err)).sum() / denom
            loss = part if loss is None else loss + part
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return {"loss": loss.detach()}

    return step
