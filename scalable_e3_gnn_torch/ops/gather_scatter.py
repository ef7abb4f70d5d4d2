"""Gathers whose gradients are gathers, on symmetric fixed-K graphs.

Counterpart of ``scalable_e3_gnn_tpu/ops/gather_scatter.py::
take_dense_symmetric_km``: ``h[senders.T]`` in the slot-major [K, N, F] order
the untabled generic message kernel reads, whose VJP sums each node's
cotangents at the reverse slots of its own K edges (a dense gather and a sum
over K) instead of scattering them.  Valid only for symmetrized graphs
(``graph.radius.symmetrize_dense``).
"""

from __future__ import annotations

import torch

__all__ = ["gather_km", "take_dense_symmetric_km", "reverse_slot_gather_sum"]


def gather_km(h, senders):
    """h[senders.T] [K, N, F], the indices clamped into [0, N) (JAX's
    ``mode="clip"``: rows of invalid slots hold some real row and every
    consumer masks them)."""
    # a contiguous index gives a contiguous [K, N, F] (indexing keeps the
    # index's memory order)
    return h[torch.clamp(senders.t(), 0, h.shape[0] - 1).long().contiguous()]


def reverse_slot_gather_sum(g, reverse_slot):
    """d_h [N, F] from slot-major cotangents g [K, N, F]: per node t, the sum
    over its slots k of g at the reverse slot ``reverse_slot[t, k]`` (node-major
    flat ``s*K + k'``, remapped to slot-major ``k'*N + s``); slots without a
    reverse edge (``reverse_slot == N*K``) add zero.  As the JAX ``_tds_km_bwd``:
    each picked row times its 0/1 validity in g's dtype, then the K terms summed
    in fp32 in slot order and rounded once to g's dtype."""
    k, n, f = g.shape
    gf = g.reshape(k * n, f)
    rs = reverse_slot.long()
    valid = (rs < n * k).to(g.dtype)
    rs_km = torch.clamp((rs % k) * n + rs // k, 0, k * n - 1)
    acc = None
    for j in range(k):
        p = (gf[rs_km[:, j]] * valid[:, j:j + 1]).float()
        acc = p if acc is None else acc + p
    return acc.to(g.dtype)


class _TakeDenseSymmetricKm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, senders, reverse_slot):
        ctx.save_for_backward(reverse_slot)
        return gather_km(h, senders)

    @staticmethod
    def backward(ctx, g):
        (reverse_slot,) = ctx.saved_tensors
        return reverse_slot_gather_sum(g.contiguous(), reverse_slot), None, None


def take_dense_symmetric_km(h, senders, reverse_slot):
    """``gather_km(h, senders)``, [K, N, F] with ``out[k, t] = h[senders[t,
    k]]``, whose gradient in h is ``reverse_slot_gather_sum``.  The JAX
    function's ``mask`` argument is not taken: the reverse slots already mark
    the slots without a partner."""
    return _TakeDenseSymmetricKm.apply(h, senders, reverse_slot)
