"""Sender gathers of fixed-K graphs, and gathers whose gradients are gathers
on symmetric ones.

Counterpart of ``scalable_e3_gnn_tpu/ops/gather_scatter.py::gather``,
``take_dense_symmetric`` and ``take_dense_symmetric_km``: ``h[senders]``
node-major [N, K, F] (the packed lmax=1 message kernel's order) and
``h[senders.T]`` slot-major [K, N, F] (the untabled kernels' order), clamped
as JAX's ``mode="clip"``.  The ``take_dense_symmetric*`` forms have a VJP
that sums each node's cotangents at the reverse slots of its own K edges (a
dense gather and a sum over K) instead of scattering them; they are valid
only for symmetrized graphs (``graph.radius.symmetrize_dense``).
``take_dense_rev`` (the partitioned path's sender gather) has the same kind
of VJP over a precomputed transpose table, for any graph.  The plain
gathers' gradient is PyTorch's indexed accumulate, as JAX's is XLA's
scatter-add.

The COO ops of the JAX module (``segment_sum``, ``segment_mean``,
``segment_max``, ``scatter_sum``, ``spmm``, ``sddmm``, and the edge gather
``gather_coo``, JAX's ``gather`` on an [E] index) keep its padding rules:
ids outside ``[0, num_segments)`` drop, gathers clip.  None of them uses a
float atomic, so on the GPU two runs give the same bits: a segment
reduction is ``torch.segment_reduce`` over ids sorted once (a
``SegmentPlan``: the stable sort order, or none when the ids come sorted,
and each segment's offset), each segment summed in its own thread in edge
order; the gradient of ``gather_coo`` is such a sorted segment sum over
the gather's indices.  A plan depends only on the ids, so a graph builds
its plans once (``graph.container.SteerableGraph.with_plans``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["gather", "gather_km", "take_dense_symmetric", "take_dense_symmetric_km",
           "take_dense_rev", "reverse_slot_gather_sum", "reverse_slot_gather_sum_km",
           "rev_gather_sum", "SegmentPlan", "segment_plan", "coo_edge_plans", "gather_coo",
           "segment_sum",
           "segment_mean", "segment_max", "scatter_sum", "spmm", "sddmm"]


def gather(h, senders):
    """h[senders] [N, K, F], the indices clamped into [0, N) (JAX's
    ``jnp.take(h, senders, axis=0, mode="clip")``: rows of invalid slots hold
    some real row and every consumer masks them)."""
    return h[torch.clamp(senders, 0, h.shape[0] - 1).long()]


def gather_km(h, senders):
    """h[senders.T] [K, N, F], the indices clamped into [0, N) (JAX's
    ``mode="clip"``: rows of invalid slots hold some real row and every
    consumer masks them)."""
    # a contiguous index gives a contiguous [K, N, F] (indexing keeps the
    # index's memory order)
    return h[torch.clamp(senders.t(), 0, h.shape[0] - 1).long().contiguous()]


def _slot_sum(gf, rows, valid):
    """[N, F]: per node t, the sum over k of ``gf[rows[t, k]] * valid[t, k]``,
    each picked row times its 0/1 validity in gf's dtype, the K terms summed
    in fp32 in slot order and rounded once to gf's dtype.  XLA on the CPU
    sums the JAX VJPs' bf16 ``.sum(axis=1)`` so: in fp32, rounded once (bit
    for bit; sequential bf16 adds differ)."""
    acc = None
    for j in range(rows.shape[1]):
        p = (gf[rows[:, j]] * valid[:, j:j + 1]).float()
        acc = p if acc is None else acc + p
    return acc.to(gf.dtype)


def reverse_slot_gather_sum(g, reverse_slot):
    """d_h [N, F] from node-major cotangents g [N, K, F]: per node t, the sum
    over its slots k of g at the reverse slot ``reverse_slot[t, k]`` (flat
    ``s*K + k'``); slots without a reverse edge (``reverse_slot == N*K``) add
    zero.  As the JAX ``_tds_bwd``."""
    n, k, f = g.shape
    rs = reverse_slot.long()
    valid = (rs < n * k).to(g.dtype)
    return _slot_sum(g.reshape(n * k, f), torch.clamp(rs, 0, n * k - 1), valid)


def reverse_slot_gather_sum_km(g, reverse_slot):
    """d_h [N, F] from slot-major cotangents g [K, N, F]: per node t, the sum
    over its slots k of g at the reverse slot ``reverse_slot[t, k]`` (node-major
    flat ``s*K + k'``, remapped to slot-major ``k'*N + s``); slots without a
    reverse edge (``reverse_slot == N*K``) add zero.  As the JAX
    ``_tds_km_bwd``."""
    k, n, f = g.shape
    rs = reverse_slot.long()
    valid = (rs < n * k).to(g.dtype)
    rs_km = torch.clamp((rs % k) * n + rs // k, 0, k * n - 1)
    return _slot_sum(g.reshape(k * n, f), rs_km, valid)


class _TakeDenseSymmetric(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, senders, reverse_slot):
        ctx.save_for_backward(reverse_slot)
        return gather(h, senders)

    @staticmethod
    def backward(ctx, g):
        (reverse_slot,) = ctx.saved_tensors
        return reverse_slot_gather_sum(g.contiguous(), reverse_slot), None, None


def take_dense_symmetric(h, senders, reverse_slot):
    """``gather(h, senders)``, [N, K, F] with ``out[t, k] = h[senders[t, k]]``,
    whose gradient in h is ``reverse_slot_gather_sum``.  The JAX function's
    ``mask`` argument is not taken: the reverse slots already mark the slots
    without a partner."""
    return _TakeDenseSymmetric.apply(h, senders, reverse_slot)


class _TakeDenseSymmetricKm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, senders, reverse_slot):
        ctx.save_for_backward(reverse_slot)
        return gather_km(h, senders)

    @staticmethod
    def backward(ctx, g):
        (reverse_slot,) = ctx.saved_tensors
        return reverse_slot_gather_sum_km(g.contiguous(), reverse_slot), None, None


def take_dense_symmetric_km(h, senders, reverse_slot):
    """``gather_km(h, senders)``, [K, N, F] with ``out[k, t] = h[senders[t,
    k]]``, whose gradient in h is ``reverse_slot_gather_sum_km``.  The JAX
    function's ``mask`` argument is not taken: the reverse slots already mark
    the slots without a partner."""
    return _TakeDenseSymmetricKm.apply(h, senders, reverse_slot)


# columns of the transpose table summed per block once it has more than this
_REV_BLOCK = 16


def rev_gather_sum(g, rev):
    """d_h [M, F] from node-major cotangents g [R, K, F]: per row m, the sum of
    g at the flat slots ``rev[m, q] - 1`` (the +1 encoding: 0 is empty and
    adds zero).  As the JAX ``_tdr_bwd``: up to 16 columns one sum over the
    columns (in fp32 in column order, rounded once to g's dtype); beyond, the
    columns in blocks of 16 (zero-padded), each block summed so and added to
    an accumulator in g's dtype, so the [M, Q, F] transient stays bounded."""
    r, k, f = g.shape
    gf = g.reshape(r * k, f)
    rv = rev.long()
    valid = (rv > 0).to(g.dtype)
    rows = torch.clamp(rv - 1, 0, r * k - 1)
    q = rv.shape[1]
    if q <= _REV_BLOCK:
        return _slot_sum(gf, rows, valid)
    acc = g.new_zeros((rv.shape[0], f))
    for lo in range(0, q, _REV_BLOCK):
        # the zero padding of the last block's columns adds exact zeros
        acc = acc + _slot_sum(gf, rows[:, lo:lo + _REV_BLOCK], valid[:, lo:lo + _REV_BLOCK])
    return acc


class _TakeDenseRev(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, senders, rev):
        ctx.save_for_backward(rev)
        ctx.shape = tuple(senders.shape)
        return gather(h, senders)

    @staticmethod
    def backward(ctx, g):
        (rev,) = ctx.saved_tensors
        return rev_gather_sum(g.contiguous().reshape(*ctx.shape, -1), rev), None, None


def take_dense_rev(h, senders, rev):
    """``gather(h, senders)``, [R, K, F] with ``out[t, k] = h[senders[t, k]]``
    (indices clamped; padding slots hold some real row and every consumer
    masks them), whose gradient in h is ``rev_gather_sum`` over ``rev`` [M,
    Q], the flat slots (+1, 0 empty) where each row of h is a sender: a gather
    instead of a scatter, for any graph whose transpose table is built
    (``parallel.partition.partition_graph_dense``'s ``rev_int``/``rev_ext``)."""
    return _TakeDenseRev.apply(h, senders, rev)


class SegmentPlan(NamedTuple):
    """Ids grouped by segment: ``order`` the stable sort of the ids (None
    when they come sorted), ``offsets`` [S + 1] the first sorted position of
    each segment and the end; ids outside ``[0, S)`` lie in no segment."""

    order: Optional[torch.Tensor]
    offsets: torch.Tensor


def segment_plan(segment_ids, num_segments: int, indices_are_sorted: bool = False) -> SegmentPlan:
    """The ``SegmentPlan`` of ``segment_ids`` [E] into ``num_segments``
    segments (no host sync: a stable sort and a binary search)."""
    ids = segment_ids.long()
    order = None
    if not indices_are_sorted:
        ids, order = torch.sort(ids, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=ids.dtype, device=ids.device)
    return SegmentPlan(order, torch.searchsorted(ids.contiguous(), bounds))


def coo_edge_plans(senders, receivers, n: int, n_src: int):
    """The three ``SegmentPlan``s of an [E] edge list that the COO messages
    read: the clipped senders into ``n_src`` rows (the sender gather's
    gradient), the clipped receivers (the receiver gather's gradient) and
    the receivers (the aggregation; the trash id ``n`` drops), both into
    ``n`` rows, the receivers sorted."""
    recv = receivers.long()
    return (segment_plan(torch.clamp(senders.long(), 0, n_src - 1), n_src),
            segment_plan(torch.clamp(recv, 0, n - 1), n, indices_are_sorted=True),
            segment_plan(recv, n, indices_are_sorted=True))


def _reduce(data, plan: SegmentPlan, reduce: str):
    x = data if plan.order is None else data[plan.order]
    return torch.segment_reduce(x.contiguous(), reduce, offsets=plan.offsets, axis=0,
                                unsafe=True)


class _GatherCoo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, order, offsets):
        ctx.save_for_backward(order, offsets)
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        order, offsets = ctx.saved_tensors
        return _reduce(g, SegmentPlan(order, offsets), "sum"), None, None, None


def gather_coo(x, idx, plan: Optional[SegmentPlan] = None):
    """Per-edge gather of rows ``x[idx]`` for an [E] index, out-of-range
    indices clipped into ``[0, N)`` (JAX's ``gather``, ``mode="clip"``).  Its
    gradient in x is the sorted segment sum of the cotangent rows over the
    clipped indices; ``plan``: their ``segment_plan`` into N segments, made
    here when not given."""
    n = x.shape[0]
    idx = torch.clamp(idx.long(), 0, n - 1)
    plan = plan if plan is not None else segment_plan(idx, n)
    return _GatherCoo.apply(x, idx, plan.order, plan.offsets)


def segment_sum(data, segment_ids, num_segments: int, indices_are_sorted: bool = False,
                plan: Optional[SegmentPlan] = None):
    """Sum the rows of ``data`` into ``num_segments`` buckets; ids outside
    ``[0, num_segments)`` drop (the trash segment of padding edges).  Each
    bucket sums its rows in their order (after a stable sort of unsorted
    ids); an empty bucket is zero.  ``plan``: ``segment_plan`` of the ids."""
    plan = plan if plan is not None else segment_plan(segment_ids, num_segments,
                                                       indices_are_sorted)
    return _reduce(data, plan, "sum")


def segment_mean(data, segment_ids, num_segments: int, indices_are_sorted: bool = False,
                 eps: float = 1e-9, plan: Optional[SegmentPlan] = None):
    """``segment_sum`` over the count of each bucket's rows, at least ``eps``."""
    plan = plan if plan is not None else segment_plan(segment_ids, num_segments,
                                                       indices_are_sorted)
    s = _reduce(data, plan, "sum")
    cnt = _reduce(data.new_ones(data.shape[:1]), plan, "sum")
    cnt = torch.clamp(cnt, min=eps)
    return s / (cnt[:, None] if data.dim() > 1 else cnt)


def segment_max(data, segment_ids, num_segments: int, indices_are_sorted: bool = False,
                plan: Optional[SegmentPlan] = None):
    """Per-bucket maximum of floating ``data``; an empty bucket is -inf (as
    ``jax.ops.segment_max``); ids outside ``[0, num_segments)`` drop."""
    plan = plan if plan is not None else segment_plan(segment_ids, num_segments,
                                                       indices_are_sorted)
    out = _reduce(data, plan, "max")
    empty = (plan.offsets[1:] == plan.offsets[:-1]).reshape((-1,) + (1,) * (out.dim() - 1))
    return torch.where(empty, torch.full_like(out, float("-inf")), out)


def scatter_sum(messages, receivers, num_nodes: int, indices_are_sorted: bool = False,
                plan: Optional[SegmentPlan] = None):
    """``segment_sum`` with message-passing names."""
    return segment_sum(messages, receivers, num_nodes, indices_are_sorted, plan)


def spmm(edge_weights, node_features, senders, receivers, num_nodes: int,
         indices_are_sorted: bool = False):
    """out[r] = sum over edges e with receiver r of w_e * x[s_e] (``edge_weights``
    None: the unweighted sum); padding edges point at receiver ``num_nodes``."""
    msgs = gather_coo(node_features, senders)
    if edge_weights is not None:
        msgs = msgs * edge_weights[:, None]
    return segment_sum(msgs, receivers, num_nodes, indices_are_sorted)


def sddmm(a, b, senders, receivers):
    """Per-edge dots <a[s_e], b[r_e]>."""
    return torch.sum(gather_coo(a, senders) * gather_coo(b, receivers), dim=-1)
