"""Batch many small graphs into one flat padded address space.

Counterpart of ``scalable_e3_gnn_tpu/graph/batching.py``: the batch is one
``SteerableGraph``; graph boundaries live in ``node_graph``; receivers stay
sorted because each graph's edges are receiver-sorted and node ids are
offset per graph.  The index arithmetic is numpy, as in JAX, so the arrays
are the same bit for bit; the result lies on the requested device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .container import SteerableGraph

__all__ = ["batch_same_size", "pad_graph"]


def batch_same_size(
    node_feats: np.ndarray,  # [G, N, F]
    positions: np.ndarray,  # [G, N, 3]
    senders: np.ndarray,  # [E] per-graph template (receiver-sorted)
    receivers: np.ndarray,  # [E]
    device=None,
) -> SteerableGraph:
    """Batch G same-topology graphs (e.g. fully connected N-body systems) on
    ``device`` (the GPU unless given)."""
    dev = resolve_device(device)
    G, N, F = node_feats.shape
    E = senders.shape[0]
    offs = (np.arange(G, dtype=np.int64) * N)[:, None]
    s = (senders[None, :] + offs).reshape(-1).astype(np.int32)
    r = (receivers[None, :] + offs).reshape(-1).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return SteerableGraph(
        nodes=t(node_feats.reshape(G * N, F)),
        positions=t(positions.reshape(G * N, 3)),
        senders=t(s),
        receivers=t(r),
        node_graph=t(np.repeat(np.arange(G, dtype=np.int32), N)),
        node_mask=torch.ones((G * N,), dtype=torch.bool, device=dev),
        edge_mask=torch.ones((G * E,), dtype=torch.bool, device=dev),
        n_graphs=G,
    )


def pad_graph(graph: SteerableGraph, num_nodes: int, num_edges: int,
              num_graphs: Optional[int] = None) -> SteerableGraph:
    """Pad to ``num_nodes`` nodes and ``num_edges`` edges: trash-segment
    edges (sender = receiver = ``num_nodes``), masked zero tail nodes in
    graph ``num_graphs`` (default: the graph's count), which pooling drops."""
    N0, E0 = graph.num_nodes, graph.num_edges
    if num_nodes < N0 or num_edges < E0:
        raise ValueError("pad target smaller than graph")
    G = num_graphs if num_graphs is not None else graph.n_graphs
    pn, pe = num_nodes - N0, num_edges - E0
    F = graph.nodes.shape[-1]
    dev = graph.device
    i32 = dict(dtype=torch.int32, device=dev)
    return SteerableGraph(
        nodes=torch.cat([graph.nodes, graph.nodes.new_zeros((pn, F))]),
        positions=torch.cat([graph.positions, graph.positions.new_zeros((pn, 3))]),
        senders=torch.cat([graph.senders.to(torch.int32), torch.full((pe,), num_nodes, **i32)]),
        receivers=torch.cat([graph.receivers.to(torch.int32),
                             torch.full((pe,), num_nodes, **i32)]),
        node_graph=torch.cat([graph.node_graph.to(torch.int32), torch.full((pn,), G, **i32)]),
        node_mask=torch.cat([graph.node_mask, torch.zeros((pn,), dtype=torch.bool, device=dev)]),
        edge_mask=torch.cat([graph.edge_mask, torch.zeros((pe,), dtype=torch.bool, device=dev)]),
        n_graphs=G,
    )
