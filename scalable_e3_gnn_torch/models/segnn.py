"""SEGNN: steerable E(3)-equivariant message passing.

Counterpart of ``scalable_e3_gnn_tpu/models/segnn.py`` on both of its graph
forms: the COO ``SteerableGraph`` (batches of small graphs: the N-body and
QM9 configs) and the fixed-K ``DenseEdgeGraph`` (point clouds), the latter
with its memory ladder (``remat``, ``remat_kernel``, ``edge_chunks``,
``remat_layers``):

    h = embed(x, node_attr)
    per layer: agg_i = sum_k mask * MLP([h_s || h_i || d^2], edge_attr)
               h_i   = h_i + update([h_i || agg_i], node_attr)
    out = head(pre_head(h, node_attr))

Parameter names follow the JAX ``init`` dict (``embed``, ``layer_i/msg_j``,
``layer_i/upd_j``, ``pre_head``, ``head``) so ``utils.params.params_from_jax``
loads JAX weights unchanged.

On a ``SteerableGraph`` (``SEGNNLayer.apply``, as the JAX ``apply``) the
messages are plain PyTorch whatever ``use_pallas`` says (JAX's kernels,
too, serve only the dense graph): senders and receivers gathered by
``ops.gather_scatter.gather_coo``, the masked messages summed per receiver
by ``segment_sum``, both over the graph's segment plans, so no float
atomic runs and two runs on the GPU give the same bits; ``remat``
checkpoints the messages and the aggregation.

Message dispatch on a ``DenseEdgeGraph`` (``SEGNNLayer``):
- ``use_pallas=True``, hidden ``Hs x0e + Hv x1o`` (lmax=1), on a graph with
  gather tables: the tabled lmax=1 kernel
  (``kernels.fused_message.fused_message_aggregate_tabled``), which runs the
  hand-written CUDA kernels (forward, and backward under autograd) on CUDA
  tensors;
- ``use_pallas=True`` with any other hidden irreps (the lmax=2 configs)
  (``_fused_messages_generic``, ``kernels.fused_message_generic.
  FusedMessageGeneric``): on a graph with gather tables at
  ``_pick_generic_tile(n)`` and n a multiple of it, and a kernel with a
  hand-structured backward, the tabled kernel (``geo_call_tab``: #8, then #9
  from the saved pre-gate ys or, under ``remat_kernel``, #10, which replays
  the forward); else, on a symmetrized graph under ``remat_kernel`` with n a
  multiple of the tile and ``replay_bwd``, the sym-regather entry
  (``geo_call_sym``: #11 and #13, node-sized residuals); else the untabled
  kernel on the gathered senders (``geo_call``: #11, then #12, #13 or, with
  ``replay_bwd=False`` or non-foldable message layers (``lmax_attr >= 5``),
  the fallback #14 at ``_pick_bwd_tile(n)``), the gather
  ``take_dense_symmetric_km`` on a symmetrized graph (its gradient a
  reverse-slot gather) and ``h[senders.T]`` otherwise.  As in JAX, a
  non-foldable model under ``remat_kernel`` on a symmetrized graph reaches
  the sym-regather entry, which has no replay backward for it, and raises;
- ``use_pallas=True`` with lmax=1 hidden irreps and no tables, or with
  ``edge_chunks > 1`` (chunks carry no tables) (``_fused_messages``): with
  ``pack`` p > 1 dividing K, the packed lmax=1 kernel
  (``kernels.fused_message.fused_message_aggregate``: #6 forward, #7
  backward) on the node-major senders, gathered by ``take_dense_symmetric``
  on a whole symmetrized graph and by ``gather`` otherwise; else the
  untabled lmax=1 kernel (``_fused_messages_km``, ``kernels.fused_message.
  fused_message_aggregate_km``: #3 forward, #5 backward) on the slot-major
  senders, gathered by ``take_dense_symmetric_km`` on a whole symmetrized
  graph (its gradient a reverse-slot gather) and by ``gather_km`` otherwise;
- ``use_pallas=False``: the plain PyTorch message path.

``SEGNNLayer.apply_dense_split`` is the layer of the dense partitioned path
(``parallel.halo``): the interior and boundary receiver blocks of a
partition, each through the same dispatch on senders pre-gathered by
``take_dense_rev`` (``hs``), which skips the tabled and sym-regather
entries.  ``SEGNNLayer.apply_split`` is the layer of the COO partitioned
path: the local and the remote edges of a partition, plain PyTorch as
``apply``.  Each comes in two halves (interior or local, then boundary or
remote with the update), which the runners call apart so that the halo
exchange runs during the first.

Rematerialisation, as in the JAX package: ``remat`` checkpoints the plain
message path and, where an update layer is a generic ``TensorProduct``, the
update; ``remat_kernel`` also checkpoints a kernel dispatch whose residuals
are edge-sized (the lmax=1 tabled kernel, the untabled generic one), but not
the tabled generic or the sym-regather one, whose replay backwards keep
node-sized tensors only.  ``edge_chunks`` streams node blocks of ``n //
edge_chunks`` (when that divides n) through the messages and the update,
each block checkpointed under ``remat`` or ``remat_kernel``; the SEGNN then
also chunks its embed and its head.  ``remat_layers`` checkpoints groups of
that many layers, so the backward keeps only the group boundaries.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.irreps import Irreps
from ..core.spherical import spherical_harmonics
from ..graph.container import CooPlans, DenseEdgeGraph, SteerableGraph
from ..kernels.fused_message import (MessageConfig, fused_message_aggregate,
                                     fused_message_aggregate_km, fused_message_aggregate_tabled)
from ..kernels.fused_message_generic import FusedMessageGeneric
from ..ops.gate import Gate
from ..ops.gather_scatter import (coo_edge_plans, gather, gather_coo, gather_km, segment_mean,
                                  segment_sum, take_dense_rev, take_dense_symmetric,
                                  take_dense_symmetric_km)
from ..ops.linear import O3Linear
from ..ops.tensor_product import L1TensorProduct, TensorProduct
from ..utils.device import resolve_device

__all__ = ["O3TensorProductGate", "SEGNNLayer", "SEGNN"]


def _checkpoint(modules: nn.Module, fn: Callable, *args):
    """``torch.utils.checkpoint`` of ``fn(*args)`` with the parameters of
    ``modules`` passed in as inputs and put back in place for the recompute,
    so the backward recomputes from the tensors the forward saw (the bf16
    copies that ``torch.func.functional_call`` swaps in, for one)."""
    slots = [(m, nm) for m in modules.modules() for nm, p in m._parameters.items()
             if p is not None]

    def run(*xs):
        held = [m._parameters[nm] for m, nm in slots]
        try:
            for (m, nm), p in zip(slots, xs):
                m._parameters[nm] = p
            return fn(*xs[len(slots):])
        finally:
            for (m, nm), p in zip(slots, held):
                m._parameters[nm] = p

    return checkpoint(run, *(m._parameters[nm] for m, nm in slots), *args, use_reentrant=False)


def _make_tp(irreps_in, irreps_attr, irreps_out, layout_in, layout_out, **kw):
    """The lmax=1 fast path when it applies, else the generic CG product."""
    if (irreps_in.lmax <= 1 and irreps_out.lmax <= 1
            and repr(irreps_attr.regroup()) == "1x0e+1x1o"):
        return L1TensorProduct(irreps_in, irreps_out, layout_in1=layout_in,
                               layout_out=layout_out, **kw)
    return TensorProduct(irreps_in, irreps_attr, irreps_out, layout_in1=layout_in,
                         layout_out=layout_out, **kw)


class O3TensorProductGate(nn.Module):
    """CG tensor product with the attribute, then a gate.  The TP emits
    ``scalars || gates || gated``; the gate squashes them."""

    def __init__(self, irreps_in, irreps_attr, irreps_out, act: Callable = F.silu,
                 gated: bool = True, layout_in: str = "mul", layout_out: str = "mul",
                 device=None, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.irreps_in = Irreps(irreps_in)
        self.irreps_out = Irreps(irreps_out)
        self.gated = gated
        if gated:
            scalars = Irreps([mi for mi in self.irreps_out if mi.ir.l == 0])
            non_scalars = Irreps([mi for mi in self.irreps_out if mi.ir.l > 0])
            self.gate = Gate(scalars, non_scalars, act_scalars=act, layout=layout_out)
            tp_out = self.gate.irreps_in
        else:
            self.gate = None
            tp_out = self.irreps_out
        self.tp = _make_tp(self.irreps_in, Irreps(irreps_attr), tp_out, layout_in, layout_out,
                           device=device, generator=generator)

    def forward(self, x: torch.Tensor, attr: torch.Tensor) -> torch.Tensor:
        y = self.tp(x, attr)
        return self.gate(y) if self.gate is not None else y


class SEGNNLayer(nn.Module):
    """One message-passing layer.

    message  m = TPGate([h_s || h_r || |x_rel|^2], edge_attr)  (x2)
    aggregate  = masked sum over each receiver's edges (COO: a segment sum;
                 fixed-K: the K slots)
    update     = TPGate([h_i || agg_i], node_attr)  (+ residual)
    """

    def __init__(self, hidden_irreps, attr_irreps, act: Callable = F.silu,
                 num_message_layers: int = 2, num_update_layers: int = 2,
                 layout: str = "mul", use_pallas: bool = False, remat: bool = False,
                 remat_kernel: bool = False, residual_bwd: bool = True,
                 replay_bwd: bool = True, edge_chunks: int = 1, pack: int = 1, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.layout = layout
        # pack: slots per rounding group of the packed lmax=1 kernel (#6/#7);
        # ignored where it does not divide K (the km kernel runs), and where
        # gather tables serve
        self.pack = max(1, pack)
        # edge_chunks: stream node blocks through the messages and the update
        self.edge_chunks = edge_chunks
        # remat: recompute the per-edge message intermediates (plain path)
        # and the generic update's outer products in the backward
        self.remat = remat
        # remat_kernel: also checkpoint an edge-sized kernel dispatch; the
        # tabled generic kernel instead replays its forward in its backward
        self.remat_kernel = remat_kernel
        # residual_bwd: the generic kernel saves the pre-gate ys (off under
        # remat_kernel, whose point is not to keep edge-sized tensors)
        self.residual_bwd = residual_bwd
        # replay_bwd: without the residuals, the generic kernel's backward
        # replays the forward (#10, #13); False selects the fallback #14
        self.replay_bwd = replay_bwd
        h = Irreps(hidden_irreps)
        hr = h.regroup()
        # the fused kernel: cm layout, 2 gated message layers, hidden = Hs x0e + Hv x1o
        self.use_pallas = (
            use_pallas and layout == "cm" and num_message_layers == 2 and act is F.silu
            and len(hr) == 2 and repr(hr[0].ir) == "0e" and repr(hr[1].ir) == "1o"
        )
        self._pallas_hs = hr[0].mul if self.use_pallas else 0
        self._pallas_hv = hr[1].mul if self.use_pallas else 0
        a = Irreps(attr_irreps)
        self.hidden_irreps = h
        kw = dict(act=act, device=device, generator=generator)
        edge_in = h + h + Irreps("1x0e")  # h_s || h_r || dist^2
        self.message_layers = nn.ModuleList()
        cur = edge_in
        for _ in range(num_message_layers):
            self.message_layers.append(
                O3TensorProductGate(cur, a, h, layout_in=layout, layout_out=layout, **kw))
            cur = h
        # the generic fused kernel: any hidden irreps / attribute order, cm
        # layout, generic TensorProduct message layers, each gated
        self.use_pallas_generic = (
            use_pallas and not self.use_pallas and layout == "cm"
            and all(isinstance(m.tp, TensorProduct) and m.gate is not None
                    for m in self.message_layers)
        )
        self._generic_kernels = {}  # (k, tile, bwd_tile, residual, replay) -> kernel
        self.update_layers = nn.ModuleList()
        cur = h + h
        for i in range(num_update_layers):
            self.update_layers.append(O3TensorProductGate(
                cur, a, h, gated=i < num_update_layers - 1, layout_in=layout,
                layout_out=layout, **kw))
            cur = h

    def _folded_weights(self, dt):
        """Message-layer weights with per-column norm constants folded in,
        in the data dtype (as the JAX package hands them to its kernel)."""
        out = []
        for layer in self.message_layers[:2]:
            tp = layer.tp
            n0 = torch.as_tensor(tp._norm["l0e"], device=tp.w_l0e.device).to(dt)
            n1 = torch.as_tensor(tp._norm_mul["l1o"], device=tp.w_l1o.device).to(dt)
            out += [(tp.w_l0e.to(dt) * n0[None, :]).contiguous(),
                    (tp.w_l1o.to(dt) * n1[None, :]).contiguous()]
        return out

    def _fused_messages_tabled(self, h, edge_attr, edge_dist2, edge_mask, graph):
        """Kernel dispatch with the graph's per-tile sender tables and split
        reverse table; pads the node axis to the tables' Npad and cuts the
        result back to N (both differentiable: gradients reach h and the
        message weights through the kernel's backward)."""
        loc, gtab = graph.gather_loc, graph.gather_tab
        n, k = edge_mask.shape
        f = h.shape[-1]
        npad = loc.shape[0]
        cfg = MessageConfig(hs=self._pallas_hs, hv=self._pallas_hv, k=k,
                            tile=graph.gather_tile, u=gtab.shape[1])
        dt = h.dtype
        attr = edge_attr.reshape(n * k, edge_attr.shape[-1]).to(dt)
        maskf = edge_mask.to(dt).reshape(n * k, 1)
        d2 = edge_dist2.reshape(n * k, 1).to(dt)
        h_p = h
        if npad != n:
            pe = (npad - n) * k
            h_p = torch.cat([h, h.new_zeros((npad - n, f))])
            attr = torch.cat([attr, attr.new_zeros((pe, attr.shape[-1]))])
            d2 = torch.cat([d2, d2.new_zeros((pe, 1))])
            maskf = torch.cat([maskf, maskf.new_zeros((pe, 1))])
        agg = fused_message_aggregate_tabled(
            cfg, h_p.contiguous(), d2.contiguous(), attr.contiguous(), maskf.contiguous(),
            loc.reshape(npad * k, 1).contiguous(), gtab.contiguous(),
            graph.gather_rev_dense.contiguous(), graph.gather_rem_pos.contiguous(),
            graph.gather_rem_node.contiguous(), *self._folded_weights(dt))
        return agg[:n]

    def _fused_messages(self, h_local, h_ext, senders, edge_attr, edge_dist2, edge_mask,
                        reverse_slot=None, edge_geo=None, hs=None):
        """Untabled lmax=1 dispatch (the JAX ``_fused_messages``): ``pack`` 1
        or not dividing K takes ``_fused_messages_km``; else the packed
        kernel on the node-major senders (``hs`` [N, K, F] when given
        pre-gathered, else ``take_dense_symmetric`` on a whole symmetrized
        graph or ``gather``), [N*K/p, p*F], with the flat geometry, the node
        axis zero-padded to the km tile (mask 0); the result cut back to N.
        Differentiable in h (and ``hs``) and the weights."""
        n, k = senders.shape
        p = self.pack
        if p == 1 or k % p:
            return self._fused_messages_km(h_local, h_ext, senders, edge_attr, edge_dist2,
                                           edge_mask, reverse_slot, edge_geo, hs=hs)
        tile = self._pick_km_tile(n)
        npad = -(-n // tile) * tile
        cfg = MessageConfig(hs=self._pallas_hs, hv=self._pallas_hv, k=k, tile=tile, pack=p)
        dt = h_local.dtype
        f = h_local.shape[-1]
        if hs is None:
            if reverse_slot is not None and h_ext is h_local:
                hs = take_dense_symmetric(h_ext, senders, reverse_slot)
            else:
                hs = gather(h_ext, senders)
        pad = lambda x: x if npad == n else torch.cat([x, x.new_zeros((npad - n,) + x.shape[1:])])
        hs = pad(hs).reshape(npad * k // p, p * f)
        attr = pad(edge_attr.to(dt)).reshape(npad * k // p, 4 * p)
        d2 = pad(edge_dist2.to(dt)).reshape(npad * k // p, p)
        maskf = pad(edge_mask.to(dt)).reshape(npad * k // p, p)
        agg = fused_message_aggregate(cfg, hs.contiguous(), pad(h_local).contiguous(),
                                      d2.contiguous(), attr.contiguous(), maskf.contiguous(),
                                      *self._folded_weights(dt))
        return agg[:n]

    @staticmethod
    def _pick_km_tile(n: int) -> int:
        """The untabled lmax=1 dispatch's tile: the largest multiple of 16 in
        [16, 256] that divides n, else 64 (as the JAX ``_fused_messages_km``
        picks it)."""
        for t in range(256, 15, -16):
            if n % t == 0:
                return t
        return 64

    def _fused_messages_km(self, h_local, h_ext, senders, edge_attr, edge_dist2, edge_mask,
                           reverse_slot=None, edge_geo=None, hs=None):
        """Untabled lmax=1 dispatch (the JAX ``_fused_messages_km``): the
        senders slot-major [K, N, F] (a pre-gathered node-major ``hs`` [N, K,
        F] transposed, else gathered by ``take_dense_symmetric_km`` on a whole
        symmetrized graph or ``gather_km``), the geometry as the node-major
        [N, K*6] stream, the node axis zero-padded to the tile; the result
        cut back to N.  Differentiable in h (and ``hs``) and the weights."""
        n, k = senders.shape
        tile = self._pick_km_tile(n)
        npad = -(-n // tile) * tile
        cfg = MessageConfig(hs=self._pallas_hs, hv=self._pallas_hv, k=k, tile=tile)
        dt = h_local.dtype
        if hs is not None:  # pre-gathered node-major (the take_dense_rev path)
            hs3 = hs.transpose(0, 1)
        elif reverse_slot is not None and h_ext is h_local:
            hs3 = take_dense_symmetric_km(h_ext, senders, reverse_slot)
        else:
            hs3 = gather_km(h_ext, senders)
        geo2 = self._geo2(edge_geo, edge_attr, edge_dist2, edge_mask, dt)
        hs3, geo2, h_p = self._pad_nodes(hs3, geo2, h_local, npad)
        agg = fused_message_aggregate_km(cfg, hs3.contiguous(), h_p.contiguous(),
                                         geo2.contiguous(), *self._folded_weights(dt))
        return agg[:n]

    @staticmethod
    def _pick_generic_tile(n: int) -> int:
        """The generic dispatch's tile: the largest multiple of 8 in [48, 224]
        that divides n, else 64 (as the JAX package picks it)."""
        for t in range(224, 47, -8):
            if n % t == 0:
                return t
        return 64

    def _pick_bwd_tile(self, n: int) -> int:
        """The generic kernel's backward tile (#14's per-tile weight-gradient
        rounding): the tile, except under ``remat_kernel`` with a tile above
        80, where it is the largest of 80, 64, 48, 32, 16, 8 that divides the
        padded row count (the JAX dispatch's VMEM cap)."""
        tile = self._pick_generic_tile(n)
        if self.remat_kernel and tile > 80:
            npad = -(-n // tile) * tile
            for b in (80, 64, 48, 32, 16, 8):
                if npad % b == 0:
                    return b
        return tile

    def _tab_eligible(self, n: int, graph: Optional[DenseEdgeGraph]) -> bool:
        """True when the graph carries tables for the generic dispatch: built
        at exactly ``_pick_generic_tile(n)``, with n a multiple of it (the
        dispatch then also needs a hand-structured backward)."""
        if not self.use_pallas_generic or graph is None or graph.gather_loc is None:
            return False
        if graph.gather_rev_dense is None or graph.gather_rem_pos is None:
            return False
        return (graph.gather_tile == self._pick_generic_tile(n)
                and graph.gather_loc.shape[0] == n)

    def _sym_regather_eligible(self, n: int, rs_available: bool) -> bool:
        """True when the generic dispatch takes ``geo_call_sym``: the sender
        gather inside the autograd Function and node-sized residuals, under
        ``remat_kernel`` on a symmetrized graph with n a multiple of the
        tile and the replay backward.  ``forward`` then skips the
        ``remat_kernel`` checkpoint, which would only add a redundant kernel
        forward.  As in JAX the layer's ``replay_bwd`` is read, not the
        kernel's: non-foldable layers take this entry and raise there."""
        return (self.use_pallas_generic and self.remat_kernel and self.replay_bwd
                and rs_available and n % self._pick_generic_tile(n) == 0)

    @staticmethod
    def _pad_nodes(hs, geo2, h, npad):
        """Slot-major senders hs [K, n, F], geometry geo2 [n, G] and receivers
        h [n, F] zero-padded to npad nodes (mask 0 on the padded slots)."""
        k, n, f = hs.shape
        if npad == n:
            return hs, geo2, h
        return (torch.cat([hs, hs.new_zeros((k, npad - n, f))], dim=1),
                torch.cat([geo2, geo2.new_zeros((npad - n, geo2.shape[-1]))]),
                torch.cat([h, h.new_zeros((npad - n, f))]))

    @staticmethod
    def _geo2(edge_geo, edge_attr, edge_dist2, edge_mask, dt):
        """Node-major packed geometry [N, K*(A+2)] (attr || d2 || mask per
        slot): the precomputed ``edge_geo`` when given, else built here."""
        if edge_geo is not None:
            return edge_geo.to(dt).reshape(edge_geo.shape[0], -1)
        geo = torch.cat([edge_attr.to(dt), edge_dist2[..., None].to(dt),
                         edge_mask[..., None].to(dt)], dim=-1)
        return geo.reshape(edge_attr.shape[0], -1)

    def _fused_messages_generic(self, h_local, h_ext, senders, edge_attr, edge_dist2,
                                edge_mask, reverse_slot=None, edge_geo=None,
                                graph: Optional[DenseEdgeGraph] = None, hs=None):
        """Generic-kernel dispatch (the JAX ``_fused_messages_generic``): the
        tabled entry when ``graph``'s tables serve this block, the sym-regather
        entry when eligible (neither when ``hs`` is given), else ``geo_call``
        on the slot-major senders (a pre-gathered node-major ``hs`` [N, K, F]
        transposed), the node axis padded to the tile (64 when no multiple
        of 8 in [48, 224] divides n)."""
        n, k = senders.shape
        tile = self._pick_generic_tile(n)
        npad = -(-n // tile) * tile
        key = (k, tile, self._pick_bwd_tile(n), self.residual_bwd and not self.remat_kernel,
               self.replay_bwd)
        if key not in self._generic_kernels:
            self._generic_kernels[key] = FusedMessageGeneric(
                self.message_layers, k, tile=tile, bwd_tile=key[2], residual_bwd=key[3],
                replay_bwd=key[4])
        kern = self._generic_kernels[key]
        geo2 = self._geo2(edge_geo, edge_attr, edge_dist2, edge_mask, h_local.dtype)
        own = hs is None and h_ext is h_local and npad == n
        if own and self._tab_eligible(n, graph) and (kern.residual_bwd or kern.replay_bwd):
            return kern.geo_call_tab(h_local, geo2, graph.gather_loc, graph.gather_tab,
                                     graph.gather_rev_dense, graph.gather_rem_pos,
                                     graph.gather_rem_node)
        if own and reverse_slot is not None and self._sym_regather_eligible(n, True):
            return kern.geo_call_sym(h_local, geo2, senders, reverse_slot)
        if hs is not None:  # pre-gathered node-major (the take_dense_rev path)
            hs = hs.transpose(0, 1)
        elif reverse_slot is not None and h_ext is h_local:
            hs = take_dense_symmetric_km(h_ext, senders, reverse_slot)
        else:
            hs = gather_km(h_ext, senders)
        hs, geo2, h_p = self._pad_nodes(hs, geo2, h_local, npad)
        return kern.geo_call(hs, h_p, geo2)[:n]

    def _plain_messages(self, h_ext, h_local, senders, edge_attr, edge_dist2, edge_mask,
                        hs=None):
        if hs is None:
            hs = h_ext[torch.clamp(senders, max=h_ext.shape[0] - 1).long()]  # [N, K, F]
        hr = h_local[:, None, :].expand_as(hs)
        m = torch.cat([hs, hr, edge_dist2[..., None].to(h_local.dtype)], dim=-1)
        for layer in self.message_layers:
            m = layer(m, edge_attr)
        m = torch.where(edge_mask[..., None], m, torch.zeros_like(m))
        return m.sum(dim=1)

    def _coo_messages(self, h_local, h_src, senders, receivers, edge_mask, edge_attr,
                      edge_dist2, plans=None):
        """agg [N, F]: the masked messages of the [E] edges from senders in
        ``h_src`` to receivers in ``h_local`` (sorted; padding = N, the trash
        segment), both gathers clipped, summed per receiver.  ``plans``: the
        edges' ``coo_edge_plans``, made here when not given."""
        n = h_local.shape[0]
        if plans is None:
            plans = coo_edge_plans(senders, receivers, n, h_src.shape[0])
        send_p, recv_gather_p, recv_p = plans
        m = torch.cat([gather_coo(h_src, senders, send_p),
                       gather_coo(h_local, receivers, recv_gather_p),
                       edge_dist2[:, None].to(h_local.dtype)], dim=-1)
        for layer in self.message_layers:
            m = layer(m, edge_attr)
        m = torch.where(edge_mask[:, None], m, torch.zeros_like(m))
        return segment_sum(m, receivers, n, plan=recv_p)

    def apply(self, h_local, h_ext, senders, receivers, edge_attr, node_attr, edge_dist2,
              edge_mask, node_mask, plans: Optional[CooPlans] = None):
        """COO message -> aggregate -> update (the JAX ``apply``): messages of
        the [E] edges from senders in ``h_ext`` [N_ext >= N, F] to receivers
        in ``h_local`` [N, F] (sorted; padding = N, the trash segment), both
        gathers clipped, masked by ``edge_mask`` and summed per receiver;
        then the update with the residual, zero on masked nodes.  Single
        device: ``h_ext`` is ``h_local``.  ``plans``: the graph's
        ``CooPlans`` (its ``send`` plan then indexes ``h_ext``), made here
        when not given."""
        plans = None if plans is None else (plans.send, plans.recv_gather, plans.recv)

        def messages_and_aggregate(h_local_, h_ext_):
            return self._coo_messages(h_local_, h_ext_, senders, receivers, edge_mask,
                                      edge_attr, edge_dist2, plans)

        if self.remat:
            agg = _checkpoint(self.message_layers, messages_and_aggregate, h_local, h_ext)
        else:
            agg = messages_and_aggregate(h_local, h_ext)
        out = h_local + self._update_u(h_local, agg, node_attr)
        return torch.where(node_mask[:, None], out, torch.zeros_like(out))

    def apply_split_local(self, h_local, loc_edges, plans=None):
        """The local half of ``apply_split``: agg [N, F] of the local edges
        (``loc_edges`` = (senders, receivers, mask, edge_attr, dist2), senders
        local rows), which reads no halo."""
        return self._coo_messages(h_local, h_local, *loc_edges, plans=plans)

    def apply_split_remote(self, h_local, h_ext, agg_local, rem_edges, node_attr, node_mask,
                           plans=None):
        """The remote half of ``apply_split``: ``agg_local`` plus the
        messages of the remote edges (senders in ``h_ext``, the halo slots),
        then the update layers, the residual and the node mask."""
        agg = agg_local + self._coo_messages(h_local, h_ext, *rem_edges, plans=plans)
        out = h_local + self._update_u(h_local, agg, node_attr)
        return torch.where(node_mask[:, None], out, torch.zeros_like(out))

    def apply_split(self, h_local, h_ext, loc_edges, rem_edges, node_attr, node_mask,
                    loc_plans=None, rem_plans=None):
        """One layer of a partition of the COO partitioned path (the JAX
        ``apply_split``; ``parallel.partition.PartitionedGraph``): the local
        edges' aggregation reads only ``h_local`` [N, F], the remote edges'
        ``h_ext`` [N + H, F] (local rows, then the halo slots); ``agg = local
        + remote``, in that order, then the update.  ``loc_edges`` and
        ``rem_edges``: (senders, receivers, mask, edge_attr, dist2); the
        plans: their ``coo_edge_plans`` (made here when not given).  The
        partitioned runners call the two halves apart, so that the halo
        exchange runs during the local one."""
        agg = self.apply_split_local(h_local, loc_edges, loc_plans)
        return self.apply_split_remote(h_local, h_ext, agg, rem_edges, node_attr, node_mask,
                                       rem_plans)

    def forward(self, h, graph, edge_attr, node_attr, edge_dist2, edge_geo=None):
        """h [N, F] -> [N, F] on ``graph``, dispatched on its type.

        A ``SteerableGraph`` (the JAX ``__call__``, which returns the graph
        with these node features) runs ``apply`` with [E, .] geometry.  A
        fixed-K ``DenseEdgeGraph`` takes [N, K, .] geometry; ``edge_geo``
        [N, K*(A+2)] is its packed geometry stream, with which ``edge_attr``
        and ``edge_dist2`` may be None (geo-only attributes): they and the
        slot mask are then read from the stream."""
        if isinstance(graph, SteerableGraph):
            return self.apply(h, h, graph.senders, graph.receivers, edge_attr, node_attr,
                              edge_dist2, graph.edge_mask, graph.node_mask, plans=graph.plans)
        n = h.shape[0]
        pallas = self.use_pallas or self.use_pallas_generic
        chunks = self.edge_chunks if n % max(self.edge_chunks, 1) == 0 else 1
        if chunks > 1:
            # node blocks: the per-slot tensors live one block at a time; the
            # reverse slots and gather tables span the whole graph, so a
            # block has neither
            c = n // chunks

            def block(h_ext, i):
                sl = slice(i * c, (i + 1) * c)
                part = lambda x: None if x is None else x[sl]
                return self._messages(h_ext, h_ext[sl], graph.senders[sl], part(edge_attr),
                                      part(edge_dist2), graph.edge_mask[sl], part(edge_geo))

            ckpt = self.remat or self.remat_kernel
            agg = torch.cat([_checkpoint(self.message_layers, block, h, i) if ckpt
                             else block(h, i) for i in range(chunks)])
        else:
            rs = graph.reverse_slot
            sym = rs is not None and self._sym_regather_eligible(n, True)
            tab = self._tab_eligible(n, graph)

            def whole(h_):
                return self._messages(h_, h_, graph.senders, edge_attr, edge_dist2,
                                      graph.edge_mask, edge_geo, rs, graph)

            if (self.remat and not pallas) or (self.remat_kernel and pallas and not (sym or tab)):
                agg = _checkpoint(self.message_layers, whole, h)
            else:
                agg = whole(h)
        return self._update(h, agg, node_attr, graph, chunks)

    def _messages(self, h_ext, h_local, senders, edge_attr, edge_dist2, edge_mask, edge_geo,
                  reverse_slot=None, graph: Optional[DenseEdgeGraph] = None):
        """agg [N_local, F]: the masked K-slot sum of the messages to the
        receivers ``h_local`` from senders in ``h_ext``, through the dispatch
        the layer was built for; ``graph``: the whole graph when the block is
        (its tables may serve), else None."""
        if self.use_pallas_generic:
            return self._fused_messages_generic(
                h_local, h_ext, senders, edge_attr, edge_dist2, edge_mask,
                reverse_slot=reverse_slot, edge_geo=edge_geo,
                graph=graph if h_ext is h_local else None)
        if edge_attr is None:
            if edge_geo is None:
                raise ValueError("attrs gave neither edge_attr nor edge_geo")
            g3 = edge_geo.reshape(edge_geo.shape[0], edge_mask.shape[1], -1)
            a_dim = g3.shape[-1] - 2
            edge_attr, edge_dist2, edge_mask = g3[..., :a_dim], g3[..., a_dim], g3[..., a_dim + 1] > 0
        if self.use_pallas:
            if graph is not None and graph.gather_loc is not None and h_ext is h_local:
                return self._fused_messages_tabled(h_local, edge_attr, edge_dist2, edge_mask,
                                                   graph)
            return self._fused_messages(h_local, h_ext, senders, edge_attr, edge_dist2,
                                        edge_mask, reverse_slot, edge_geo)
        return self._plain_messages(h_ext, h_local, senders, edge_attr, edge_dist2, edge_mask)

    def _dense_block(self, h_r, h_src, edges):
        """agg [Nb, F] of one receiver block of the dense partitioned path:
        ``edges`` = (senders [Nb, K] into ``h_src``, attr, dist2, mask[,
        rev]); a block without rows gives zeros and launches nothing."""
        pallas = self.use_pallas or self.use_pallas_generic

        def msgs(h_r, h_src, senders, eattr, d2, mask, rev=None):
            if h_r.shape[0] == 0:
                return h_r.new_zeros((0, h_r.shape[-1]))
            hs = None if rev is None else take_dense_rev(h_src, senders, rev)
            if self.use_pallas:
                return self._fused_messages(h_r, h_src, senders, eattr, d2, mask, hs=hs)
            if self.use_pallas_generic:
                return self._fused_messages_generic(h_r, h_src, senders, eattr, d2, mask, hs=hs)
            return self._plain_messages(h_src, h_r, senders, eattr, d2, mask, hs=hs)

        if (self.remat and not pallas) or (self.remat_kernel and pallas):
            return _checkpoint(self.message_layers, msgs, h_r, h_src, *edges)
        return msgs(h_r, h_src, *edges)

    def apply_dense_interior(self, h_local, int_edges):
        """The interior half of ``apply_dense_split``: agg [NI, F] of the
        interior block, which reads only ``h_local``."""
        return self._dense_block(h_local[:int_edges[0].shape[0]], h_local, int_edges)

    def apply_dense_boundary(self, h_local, h_ext, agg_int, bnd_edges, node_attr, node_mask):
        """The boundary half of ``apply_dense_split``: the boundary block's
        agg on ``h_ext`` after ``agg_int``, then the update layers, the
        residual and the node mask."""
        agg = torch.cat([agg_int, self._dense_block(h_local[agg_int.shape[0]:], h_ext,
                                                    bnd_edges)])
        out = h_local + self._update_u(h_local, agg, node_attr)
        return torch.where(node_mask[:, None], out, torch.zeros_like(out))

    def apply_dense_split(self, h_local, h_ext, int_edges, bnd_edges, node_attr, node_mask):
        """One layer of a partition of the dense partitioned path (the JAX
        ``apply_dense_split``; ``parallel.partition.DensePartitionedGraph``).

        ``h_local`` [NI + NB, F] holds the interior rows then the boundary
        rows, ``h_ext`` [NI + NB + H, F] the local rows then the halo slots.
        ``int_edges`` = (senders [NI, K] local rows, attr, dist2, mask[, rev])
        and ``bnd_edges`` = (senders [NB, K] extended rows, ...): the interior
        block reads only ``h_local``, the boundary block ``h_ext``.  Both go
        through the dispatch the layer was built for; a block without rows
        gives zeros and launches nothing.  With the fifth entry (the block's
        transpose table) the sender gather is ``take_dense_rev``, whose
        gradient is a gather.  The update layers and the node mask follow.
        The partitioned runners call the two halves apart
        (``apply_dense_interior``, ``apply_dense_boundary``), so that the halo
        exchange runs during the interior block."""
        agg_int = self.apply_dense_interior(h_local, int_edges)
        return self.apply_dense_boundary(h_local, h_ext, agg_int, bnd_edges, node_attr,
                                         node_mask)

    def _update_u(self, h, agg, node_attr):
        u = torch.cat([h, agg], dim=-1)
        for layer in self.update_layers:
            u = layer(u, node_attr)
        return u

    def _update(self, h, agg, node_attr, graph, chunks: int = 1):
        # the generic TP's outer product z ([N, ~1.6k] at lmax=2) is the
        # largest node-level intermediate: recompute it in the backward
        # (always when chunked: each block's z would otherwise be kept)
        ckpt = (self.remat or chunks > 1) and any(
            isinstance(layer.tp, TensorProduct) for layer in self.update_layers)
        upd = lambda *xs: (_checkpoint(self.update_layers, self._update_u, *xs) if ckpt
                           else self._update_u(*xs))
        if chunks > 1:
            c = h.shape[0] // chunks
            u = torch.cat([upd(h[i * c:(i + 1) * c], agg[i * c:(i + 1) * c],
                               node_attr[i * c:(i + 1) * c]) for i in range(chunks)])
        else:
            u = upd(h, agg, node_attr)
        out = h + u
        return torch.where(graph.node_mask[:, None], out, torch.zeros_like(out))


class SEGNN(nn.Module):
    """Full SEGNN: embed -> message-passing layers -> output head, on a COO
    ``SteerableGraph`` or a fixed-K ``DenseEdgeGraph``.

    ``vel_attr`` adds sh(velocity) to the node attributes when the forward
    is given ``velocities``; it adds no parameter.  ``task="graph"`` sums
    the masked per-node outputs per graph.  Parameters are created on
    ``device`` (the GPU unless given) from ``generator``; load JAX weights
    with ``utils.params.params_from_jax``.  ``edge_chunks`` streams node blocks through every layer, the embed and
    the head; ``remat_layers`` (a group size, 0 for none) checkpoints groups
    of that many layers, so the backward keeps only the group boundaries
    ([N, F] each): the config-5 (10M points) memory ladder.  ``pack`` (p > 1
    dividing K) sends the untabled lmax=1 messages through the packed kernel
    (#6/#7), whose K-sum and receiver cotangent round once per group of p
    slots; it adds no parameter.  ``replay_bwd=False`` makes the generic
    kernel's backward, where it does not save the ys, the fallback #14
    instead of the replay #13 (and skips the tabled and sym-regather entries,
    which need the replay), as the JAX package's option does.
    """

    def __init__(self, input_irreps, hidden_irreps, output_irreps, lmax_attr: int = 1,
                 num_layers: int = 4, act: Callable = F.silu, task: str = "node",
                 vel_attr: bool = False, layout: Optional[str] = None, use_pallas: bool = False,
                 remat: bool = False, remat_kernel: bool = False, residual_bwd: bool = True,
                 replay_bwd: bool = True, edge_chunks: int = 1, remat_layers: int = 0,
                 pack: int = 1, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.remat_layers = int(remat_layers)
        self.input_irreps = Irreps(input_irreps)
        self.hidden_irreps = Irreps(hidden_irreps)
        self.output_irreps = Irreps(output_irreps)
        self.lmax_attr = lmax_attr
        self.attr_irreps = Irreps.spherical_harmonics(lmax_attr)
        self.task = task
        self.vel_attr = vel_attr
        self.layout = layout or "cm"
        kw = dict(act=act, device=device, generator=generator)
        self.embed = O3TensorProductGate(self.input_irreps, self.attr_irreps,
                                         self.hidden_irreps, gated=False, layout_in="mul",
                                         layout_out=self.layout, **kw)
        self.layers = nn.ModuleList(
            SEGNNLayer(self.hidden_irreps, self.attr_irreps, layout=self.layout,
                       use_pallas=use_pallas, remat=remat, remat_kernel=remat_kernel,
                       residual_bwd=residual_bwd, replay_bwd=replay_bwd,
                       edge_chunks=edge_chunks, pack=pack, **kw)
            for _ in range(num_layers)
        )
        self.pre_head = O3TensorProductGate(self.hidden_irreps, self.attr_irreps,
                                            self.hidden_irreps, layout_in=self.layout,
                                            layout_out=self.layout, **kw)
        self.head = O3Linear(self.hidden_irreps, self.output_irreps, bias=True,
                             layout_in=self.layout, layout_out="mul", device=device,
                             generator=generator)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def compute_attributes(self, graph: SteerableGraph, velocities=None):
        """``(edge_attr [E, A], node_attr [N, A], dist2 [E])`` of a COO graph:
        sh of the relative positions (zero on padding edges), their mean over
        each receiver's valid edges (padding edges go to the trash segment),
        plus sh(v) under ``vel_attr`` when ``velocities`` [N, 3] are given,
        the scalar channel then set to 1; and the squared distances."""
        rel = graph.rel_positions()
        dist2 = torch.sum(rel * rel, dim=-1)
        edge_attr = spherical_harmonics(self.lmax_attr, rel)
        edge_attr = torch.where(graph.edge_mask[:, None], edge_attr, torch.zeros_like(edge_attr))
        n = graph.num_nodes
        plan = graph.plans.attr if graph.plans is not None else None
        node_attr = segment_mean(edge_attr, torch.where(graph.edge_mask, graph.receivers.long(), n),
                                 n, plan=plan)
        if self.vel_attr and velocities is not None:
            node_attr = node_attr + spherical_harmonics(self.lmax_attr, velocities)
        node_attr = torch.cat([torch.ones_like(node_attr[:, :1]), node_attr[:, 1:]], dim=-1)
        return edge_attr, node_attr, dist2

    def compute_attributes_dense(self, graph: DenseEdgeGraph, velocities=None):
        """``(edge_attr [N,K,A], node_attr [N,A], dist2 [N,K], edge_geo [N,K*(A+2)])``:
        sh of the relative positions (zero on invalid slots), their mean per
        receiver (plus sh(v) under ``vel_attr`` when ``velocities`` are
        given) with the scalar channel reset to 1, squared distances, and
        the packed ``attr || d2 || mask`` stream of the JAX package."""
        rel = graph.rel_positions()
        dist2 = torch.sum(rel * rel, dim=-1)
        edge_attr = spherical_harmonics(self.lmax_attr, rel)
        edge_attr = torch.where(graph.edge_mask[..., None], edge_attr, torch.zeros_like(edge_attr))
        cnt = torch.clamp(graph.edge_mask.sum(dim=1), min=1)
        node_attr = edge_attr.sum(dim=1) / cnt[:, None].to(edge_attr.dtype)
        if self.vel_attr and velocities is not None:
            node_attr = node_attr + spherical_harmonics(self.lmax_attr, velocities)
        # in place: attributes are graph constants, computed once outside the
        # train step, and carry no gradient
        node_attr[..., 0] = 1.0
        edge_geo = torch.cat([edge_attr, dist2[..., None],
                              graph.edge_mask[..., None].to(edge_attr.dtype)], dim=-1)
        return edge_attr, node_attr, dist2, edge_geo.reshape(edge_geo.shape[0], -1)

    def compute_attributes_dense_chunked(self, positions, senders, edge_mask,
                                         nchunk: Optional[int] = None, dtype=torch.bfloat16):
        """Geo-only attributes ``(None, node_attr [N, A], None, edge_geo [N,
        K*(A+2)])`` built in node slabs (about 1M points each, ``nchunk``
        dividing N), so the fp32 spherical harmonics are never whole-graph
        (a one-shot [N, K, A] build at 10M points holds 5.8 GB); both cast to
        ``dtype``.  The same streams as ``compute_attributes_dense`` (the
        relative positions masked before d^2: padding slots carry zeros).
        ``vel_attr`` models raise: there is no velocity stream here."""
        if self.vel_attr:
            raise NotImplementedError(
                "chunked attrs have no velocity stream; use compute_attributes_dense")
        n, k = senders.shape
        if nchunk is None:
            nchunk = max(n // 1_000_000, 1)
        while nchunk > 1 and n % nchunk:
            nchunk -= 1
        c = n // nchunk
        geos, nas = [], []
        for i in range(nchunk):
            sl = slice(i * c, (i + 1) * c)
            mk = edge_mask[sl]
            rel = positions[torch.clamp(senders[sl], max=n - 1).long()] - positions[sl][:, None, :]
            rel = torch.where(mk[..., None], rel, torch.zeros_like(rel))
            dist2 = torch.sum(rel * rel, dim=-1)
            ea = spherical_harmonics(self.lmax_attr, rel)
            ea = torch.where(mk[..., None], ea, torch.zeros_like(ea))
            cnt = torch.clamp(mk.sum(dim=1), min=1)
            na = ea.sum(dim=1) / cnt[:, None].to(ea.dtype)
            na[..., 0] = 1.0
            geo = torch.cat([ea, dist2[..., None], mk[..., None].to(ea.dtype)], dim=-1)
            geos.append(geo.reshape(c, -1).to(dtype))
            nas.append(na.to(dtype))
        return None, torch.cat(nas), None, torch.cat(geos)

    def forward(self, graph, velocities=None, attrs: Optional[tuple] = None) -> torch.Tensor:
        """Per-node outputs [N, output dim] ('graph' task: per-graph sums) on
        a ``SteerableGraph`` or a ``DenseEdgeGraph``.

        ``velocities`` [N, 3]: read under ``vel_attr``.  ``attrs``: the
        precomputed attributes, computed here when omitted: on a COO graph
        the ``compute_attributes`` 3-tuple; on a dense one the
        ``compute_attributes_dense`` result (3- or 4-tuple; the 4-tuple may
        be geo-only, ``(None, node_attr, None, edge_geo)``).  Runs in the
        dtype of ``graph.nodes`` with the module's parameters (cast the
        module, e.g. ``.to(torch.bfloat16)``, for bf16 weights)."""
        if graph.device != self.device:
            raise ValueError(f"graph is on {graph.device}, model on {self.device}")
        if isinstance(graph, SteerableGraph):
            return self._forward_coo(graph, velocities, attrs)
        if attrs is None:
            attrs = self.compute_attributes_dense(graph, velocities)
        edge_attr, node_attr, dist2 = attrs[:3]
        edge_geo = attrs[3] if len(attrs) == 4 else None
        n = graph.nodes.shape[0]
        ec = self.layers[0].edge_chunks if len(self.layers) else 1
        chunked = ec > 1 and n % ec == 0
        blocks = [slice(i * (n // ec), (i + 1) * (n // ec)) for i in range(ec)] if chunked else []
        if chunked:  # each node block checkpointed: its outer products are not kept
            h = torch.cat([_checkpoint(self.embed, self.embed, graph.nodes[sl], node_attr[sl])
                           for sl in blocks])
        else:
            h = self.embed(graph.nodes, node_attr)
        run = lambda layer, h_: layer(h_, graph, edge_attr, node_attr, dist2, edge_geo)
        g = self.remat_layers
        if g:
            for start in range(0, len(self.layers), g):
                grp = nn.ModuleList(self.layers[start:start + g])

                def body(h_, grp=grp):
                    for layer in grp:
                        h_ = run(layer, h_)
                    return h_

                h = _checkpoint(grp, body, h)
        else:
            for layer in self.layers:
                h = run(layer, h)
        if chunked:
            heads = nn.ModuleList([self.pre_head, self.head])
            head = lambda h_, na_: self.head(self.pre_head(h_, na_))
            out = torch.cat([_checkpoint(heads, head, h[sl], node_attr[sl]) for sl in blocks])
        else:
            out = self.head(self.pre_head(h, node_attr))
        return self._pool(out, graph)

    def _pool(self, out, graph, plan=None):
        """'graph' task: the masked node outputs summed per graph in node
        order (ids >= n_graphs drop); 'node': ``out`` unchanged."""
        if self.task != "graph":
            return out
        out = torch.where(graph.node_mask[:, None], out, torch.zeros_like(out))
        return segment_sum(out, graph.node_graph, graph.n_graphs, plan=plan)

    def _forward_coo(self, graph: SteerableGraph, velocities=None, attrs=None):
        """The JAX ``__call__`` on a COO graph; its segment plans built once
        here when the graph carries none."""
        if graph.plans is None:
            graph = graph.with_plans()
        if attrs is not None:
            edge_attr, node_attr, dist2 = attrs
        else:
            edge_attr, node_attr, dist2 = self.compute_attributes(graph, velocities)
        h = self.embed(graph.nodes, node_attr)
        for layer in self.layers:
            h = layer(h, graph, edge_attr, node_attr, dist2)
        out = self.head(self.pre_head(h, node_attr))
        return self._pool(out, graph, graph.plans.pool)
