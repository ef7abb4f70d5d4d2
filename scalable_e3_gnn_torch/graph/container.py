"""Graph containers: the COO ``SteerableGraph`` and the fixed-degree
``DenseEdgeGraph`` with per-tile compact sender tables.

Counterpart of ``scalable_e3_gnn_tpu/graph/container.py``: plain dataclasses
of tensors with the JAX field names, layouts and pad conventions (COO:
padding edges carry ``senders == receivers == N``, the trash segment, and
receivers are sorted; padding nodes sit at the tail with ``node_mask``
False and ``node_graph`` = G; dense tables: loc pad = U, tab pad = Npad, rev
pad = ntiles*U, rem-node pad = Npad), so the two packages can be compared
array for array.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.gather_scatter import SegmentPlan, coo_edge_plans, segment_plan
from ..utils.device import as_tensor

__all__ = ["SteerableGraph", "DenseEdgeGraph", "CooPlans"]


class CooPlans(NamedTuple):
    """The ``SegmentPlan``s of a COO graph's index arrays, which the model's
    gathers and segment sums read: the clipped senders (the sender gather's
    gradient), the clipped receivers (the receiver gather's gradient), the
    receivers (the aggregation; trash ids drop), the receivers of the valid
    edges only (the node attributes' mean), and ``node_graph`` (graph
    pooling; padding nodes drop)."""

    send: SegmentPlan
    recv_gather: SegmentPlan
    recv: SegmentPlan
    attr: SegmentPlan
    pool: SegmentPlan


# fields whose change invalidates a graph's plans
_TOPOLOGY = ("nodes", "senders", "receivers", "edge_mask", "node_graph", "n_graphs")


@dataclasses.dataclass(frozen=True)
class SteerableGraph:
    """A batch of graphs flattened into one node/edge address space (COO).

    ``plans`` (``with_plans``): the segment plans of the index arrays, built
    once per graph; the model builds them per call when absent."""

    nodes: torch.Tensor  # [N_pad, F] steerable node features (flat irreps layout)
    positions: torch.Tensor  # [N_pad, 3]
    senders: torch.Tensor  # [E_pad] int32; padding = N_pad
    receivers: torch.Tensor  # [E_pad] int32, sorted ascending; padding = N_pad
    node_graph: torch.Tensor  # [N_pad] graph id per node (pooling); padding = G
    node_mask: torch.Tensor  # [N_pad] bool
    edge_mask: torch.Tensor  # [E_pad] bool
    n_graphs: int = 1
    plans: Optional[CooPlans] = None

    def _replace(self, **kw) -> "SteerableGraph":
        if "plans" not in kw and any(k in kw for k in _TOPOLOGY):
            kw["plans"] = None
        return dataclasses.replace(self, **kw)

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]

    @property
    def device(self) -> torch.device:
        return self.senders.device

    def replace_nodes(self, nodes: torch.Tensor) -> "SteerableGraph":
        """The same graph with other node features (its plans kept)."""
        return dataclasses.replace(self, nodes=nodes)

    def rel_positions(self) -> torch.Tensor:
        """x_s - x_r per edge (pointing from receiver to sender); zero on padding."""
        n = self.num_nodes
        xs = self.positions[torch.clamp(self.senders, max=n - 1).long()]
        xr = self.positions[torch.clamp(self.receivers, max=n - 1).long()]
        rel = xs - xr
        return torch.where(self.edge_mask[:, None], rel, torch.zeros_like(rel))

    def build_plans(self) -> CooPlans:
        """The graph's ``CooPlans`` (stable sorts and binary searches on its
        device, no host sync)."""
        n = self.num_nodes
        send, recv_gather, recv = coo_edge_plans(self.senders, self.receivers, n, n)
        return CooPlans(
            send=send, recv_gather=recv_gather, recv=recv,
            attr=segment_plan(torch.where(self.edge_mask, self.receivers.long(), n), n),
            pool=segment_plan(self.node_graph, self.n_graphs),
        )

    def with_plans(self) -> "SteerableGraph":
        """This graph with its ``plans`` built."""
        return dataclasses.replace(self, plans=self.build_plans())


@dataclasses.dataclass(frozen=True)
class DenseEdgeGraph:
    """Exactly K neighbor slots per node ([N, K] arrays).

    Aggregation is a masked sum over the K axis; receiver-side features
    broadcast instead of gathering.  Built from a receiver-major fixed-K COO.
    """

    nodes: torch.Tensor  # [N, F]
    positions: torch.Tensor  # [N, 3]
    senders: torch.Tensor  # [N, K] int32; invalid slots masked
    edge_mask: torch.Tensor  # [N, K] bool
    node_mask: torch.Tensor  # [N] bool
    node_graph: torch.Tensor  # [N] graph id (pooling)
    n_graphs: int = 1
    # symmetrized graphs only (graph.radius.symmetrize_dense)
    reverse_slot: Optional[torch.Tensor] = None  # [N, K] int32
    # per-tile compact sender tables (with_gather_tables)
    gather_loc: Optional[torch.Tensor] = None  # [Npad, K] int32 -> [0, U]
    gather_tab: Optional[torch.Tensor] = None  # [ntiles, U] int32 node ids
    gather_rev: Optional[torch.Tensor] = None  # [Npad, Q] int32 flat tab slots
    gather_tile: int = 0
    # split reverse table: dense first q0 entries + node-sorted remainder COO
    gather_rev_dense: Optional[torch.Tensor] = None  # [Npad, q0]
    gather_rem_pos: Optional[torch.Tensor] = None  # [M] flat tab slots
    gather_rem_node: Optional[torch.Tensor] = None  # [M] node ids (sorted; pad=Npad)

    def _replace(self, **kw) -> "DenseEdgeGraph":
        return dataclasses.replace(self, **kw)

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def num_edges(self) -> int:
        """Edge slots, N*K, valid or not (as a COO graph counts its padding)."""
        return self.senders.shape[0] * self.senders.shape[1]

    @property
    def max_neighbors(self) -> int:
        return self.senders.shape[1]

    def replace_nodes(self, nodes: torch.Tensor) -> "DenseEdgeGraph":
        return self._replace(nodes=nodes)

    @property
    def device(self) -> torch.device:
        return self.senders.device

    @classmethod
    def from_radius_edges(
        cls, nodes, positions, edges, n_graphs=1, node_graph=None, node_mask=None,
        symmetrize: bool = False,
    ) -> "DenseEdgeGraph":
        """Build from a RadiusEdges result (receiver-major fixed-K COO), on the
        device the edges were built on.

        ``symmetrize=True`` drops K-truncation-asymmetric edges and records
        reverse-edge slots.
        """
        dev = edges.senders.device
        nodes = as_tensor(nodes, dev)
        n = nodes.shape[0]
        k = edges.senders.shape[0] // n
        senders = edges.senders.reshape(n, k)
        mask = edges.mask.reshape(n, k)
        reverse_slot = None
        if symmetrize:
            from .radius import symmetrize_dense

            mask, reverse_slot = symmetrize_dense(senders, mask)
        return cls(
            nodes=nodes,
            positions=as_tensor(positions, dev),
            senders=senders,
            edge_mask=mask,
            node_mask=(as_tensor(node_mask, dev) if node_mask is not None
                       else torch.ones((n,), dtype=torch.bool, device=dev)),
            node_graph=(as_tensor(node_graph, dev) if node_graph is not None
                        else torch.zeros((n,), dtype=torch.int32, device=dev)),
            n_graphs=n_graphs,
            reverse_slot=reverse_slot,
        )

    def rel_positions(self) -> torch.Tensor:
        """[N, K, 3]: x_s - x_r per slot; zero on invalid slots."""
        xs = self.positions[torch.clamp(self.senders, max=self.num_nodes - 1).long()]
        rel = xs - self.positions[:, None, :]
        return torch.where(self.edge_mask[..., None], rel, torch.zeros_like(rel))

    def with_gather_tables(
        self, tile: int = 64, table_size: int = 0, rev_size: int = 0
    ) -> "DenseEdgeGraph":
        """Per-tile compact sender tables, computed on the host with numpy.

        Per tile i of ``tile`` consecutive receivers: the sorted unique sender
        ids ``gather_tab[i]`` (pad Npad), each slot's index into its tile's
        table ``gather_loc`` (pad U), and per node the flat table positions
        where it appears ``gather_rev`` (pad ntiles*U), plus the split form
        of that reverse table.  ``table_size``/``rev_size`` override the
        measured U/Q.  The tables go back to the graph's device.
        """
        senders = self.senders.cpu().numpy()
        mask = self.edge_mask.cpu().numpy()
        n, k = senders.shape
        ntiles = -(-n // tile)
        npad = ntiles * tile
        s = np.full((npad, k), npad, np.int64)
        s[:n] = np.where(mask, senders, npad)
        s = s.reshape(ntiles, tile * k)

        order = np.argsort(s, axis=1, kind="stable")
        ss = np.take_along_axis(s, order, axis=1)
        new = np.ones_like(ss, bool)
        new[:, 1:] = ss[:, 1:] != ss[:, :-1]
        real = ss < npad
        newreal = new & real
        # unique-rank of each sorted slot within its tile
        rank = np.cumsum(newreal, axis=1) - 1
        counts = newreal.sum(axis=1)
        u_needed = int(counts.max()) if ntiles else 0
        u = table_size or (-(-max(u_needed, 1) // 128) * 128)
        if u < u_needed:
            raise ValueError(f"table_size {u} < required {u_needed}")

        tab = np.full((ntiles, u), npad, np.int32)
        ti = np.broadcast_to(np.arange(ntiles)[:, None], ss.shape)
        tab[ti[newreal], rank[newreal]] = ss[newreal].astype(np.int32)

        loc_sorted = np.where(real, rank, u).astype(np.int32)
        loc = np.full_like(loc_sorted, u)
        np.put_along_axis(loc, order, loc_sorted, axis=1)
        loc = loc.reshape(npad, k)

        # reverse table: flat tab positions per node id
        flat = tab.ravel()
        sel = np.nonzero(flat < n)[0]
        vals = flat[sel]
        vorder = np.argsort(vals, kind="stable")
        sv, sp = vals[vorder], sel[vorder]
        starts = np.searchsorted(sv, np.arange(n))
        ends = np.searchsorted(sv, np.arange(n) + 1)
        q_needed = int((ends - starts).max()) if n else 0
        q = rev_size or (-(-max(q_needed, 1) // 4) * 4)
        if q < q_needed:
            raise ValueError(f"rev_size {q} < required {q_needed}")
        rev = np.full((npad, q), ntiles * u, np.int32)
        within = np.arange(len(sv)) - starts[sv]
        rev[sv, within] = sp.astype(np.int32)

        # split reverse table: dense [Npad, q0] + node-sorted remainder COO
        q0 = min(2, q)
        nodes_r, cols_r = np.nonzero(rev[:, q0:] < ntiles * u)
        pos_r = rev[nodes_r, q0 + cols_r]
        m = len(pos_r)
        mcap = -(-max(m, 1) // 1024) * 1024
        rem_pos = np.zeros((mcap,), np.int32)
        rem_node = np.full((mcap,), npad, np.int32)  # pad -> trash segment
        rem_pos[:m] = pos_r.astype(np.int32)
        rem_node[:m] = nodes_r.astype(np.int32)  # row-major scan: sorted by node

        dev = self.device
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return self._replace(
            gather_loc=t(loc),
            gather_tab=t(tab),
            gather_rev=t(rev),
            gather_tile=tile,
            gather_rev_dense=t(rev[:, :q0]),
            gather_rem_pos=t(rem_pos),
            gather_rem_node=t(rem_node),
        )
