"""Dense-K (fixed-degree) graph partitioned over P Morton-contiguous ranges.

Counterpart of ``scalable_e3_gnn_tpu/parallel/partition.py::
DensePartitionedGraph`` and ``partition_graph_dense``.  The octree's Morton
sort makes contiguous node ranges spatially compact, so cutting the sorted
node array into P equal ranges gives partitions with small halos.  Edges are
owned by the receiver's partition; senders on other partitions become halo
slots, filled by the boundary exchange of every layer
(``parallel.halo.exchange_halo``).

Host numpy, run once per graph topology.  The output is the JAX function's,
array for array and bit for bit.  The JAX package runs three passes through
its native helper library where that library is built (``sender_pass``,
``take_i32``, ``rev_table_multi``); this module takes the numpy form of each
(the JAX function's own fallbacks) and loads no native code.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["DensePartitionedGraph", "partition_graph_dense"]


class DensePartitionedGraph(NamedTuple):
    """Fixed-degree partition arrays, stacked on axis 0 (one row per partition).

    Within each partition the local rows are permuted so that *interior*
    receivers (all K senders local) occupy rows [0, NI) and *boundary*
    receivers (at least one remote sender) rows [NI, NI+NB): the interior
    block's messages do not depend on the halo exchange.

    Index spaces (per partition):
      - local row: 0..NI+NB-1; padding rows have node_mask False;
      - extended: 0..NI+NB+H-1, local rows then halo slots (boundary-block
        senders); pad slot NI+NB+H (clamped by the gather, masked);
      - interior-block senders are local rows; pad slot NI+NB;
      - pool: 0..P*H-1, the position in the gathered boundary pool.
    ``global_ids`` maps local rows back to the input node order (pad -1);
    targets of a partitioned train step are ``target[global_ids]`` with the
    pad rows masked.
    """

    num_parts: int
    n_interior: int  # NI
    n_boundary: int  # NB
    halo_cap: int  # H
    k: int
    nodes: np.ndarray  # [P, NI+NB, F]
    positions_ext: np.ndarray  # [P, NI+NB+H, 3]
    node_mask: np.ndarray  # [P, NI+NB]
    senders_int: np.ndarray  # [P, NI, K] local rows; pad = NI+NB
    mask_int: np.ndarray  # [P, NI, K]
    senders_bnd: np.ndarray  # [P, NB, K] extended; pad = NI+NB+H
    mask_bnd: np.ndarray  # [P, NB, K]
    boundary_idx: np.ndarray  # [P, H] local row of exported nodes; pad 0
    halo_map: np.ndarray  # [P, H] pool index per halo slot; pad 0
    global_ids: np.ndarray  # [P, NI+NB] input-order node id; pad -1
    # sender-transpose tables (gather-only gradients, ops.take_dense_rev):
    # the flat block slots where each row is the sender, +1 (0 = empty)
    rev_int: np.ndarray  # [P, NI+NB, Qi]
    rev_ext: np.ndarray  # [P, NI+NB+H, Qb]

    @property
    def n_per_part(self) -> int:
        return self.n_interior + self.n_boundary


def _rev_table(s_blk: np.ndarray, m_blk: np.ndarray, n_targets: int) -> np.ndarray:
    """[P, n_targets, q] transpose tables of one receiver block: per target
    row, the flat slot positions (+1; 0 = empty) of the valid slots whose
    sender it is, in slot order; q = the largest count, at least 1."""
    num_parts = s_blk.shape[0]
    lists = []
    for p in range(num_parts):
        pos = np.nonzero(m_blk[p].ravel())[0]
        tgt = s_blk[p].ravel()[pos]
        order = np.argsort(tgt, kind="stable")
        tgt, pos = tgt[order], pos[order]
        starts = np.searchsorted(tgt, np.arange(n_targets))
        ends = np.searchsorted(tgt, np.arange(n_targets) + 1)
        lists.append((pos, starts, ends))
    q = max((int((e - s).max()) if len(e) else 0 for _, s, e in lists), default=0)
    q = max(q, 1)
    rev = np.zeros((num_parts, n_targets, q), np.int32)
    for p, (pos, starts, ends) in enumerate(lists):
        cnt = ends - starts
        rows = np.repeat(np.arange(n_targets), cnt)
        within = np.arange(len(pos)) - np.repeat(starts, cnt)
        rev[p, rows, within] = pos.astype(np.int32) + 1
    return rev


def partition_graph_dense(
    positions: np.ndarray,  # [N, 3] Morton-sorted
    features: np.ndarray,  # [N, F]
    senders: np.ndarray,  # [N, K] global ids
    edge_mask: np.ndarray,  # [N, K]
    num_parts: int,
) -> DensePartitionedGraph:
    """Split a dense-K graph into P Morton-contiguous partitions.

    Ownership is by receiver row range; remote senders become halo slots.
    NI, NB and H are what the graph needs, at least 1 each (so no block is
    empty).  Inputs may be numpy arrays or CPU
    tensors (anything ``np.asarray`` reads)."""
    positions = np.asarray(positions)
    features = np.asarray(features)
    senders = np.asarray(senders)
    edge_mask = np.asarray(edge_mask, bool)
    n, k = senders.shape
    f = features.shape[1]
    npp0 = -(-n // num_parts)  # input rows per partition range
    owner = lambda v: np.minimum(v // npp0, num_parts - 1)

    sd0 = np.where(edge_mask, senders, 0)
    OWNER = np.minimum(sd0 // npp0, num_parts - 1)
    OWNER = np.where(edge_mask, OWNER, -1).astype(np.int8)
    row_own = np.minimum(np.arange(n) // npp0, num_parts - 1)[:, None]
    REMOTE = edge_mask & (OWNER != row_own)
    ROW_REMOTE = REMOTE.any(axis=1)

    halos, int_rows, bnd_rows = [], [], []
    for p in range(num_parts):
        lo, hi = p * npp0, min(n, (p + 1) * npp0)
        halos.append(np.unique(senders[lo:hi][REMOTE[lo:hi]]))
        isb = ROW_REMOTE[lo:hi]
        int_rows.append(np.nonzero(~isb)[0] + lo)
        bnd_rows.append(np.nonzero(isb)[0] + lo)

    ni_need = max((len(r) for r in int_rows), default=0)
    nb_need = max((len(r) for r in bnd_rows), default=0)
    NI = max(ni_need, 1)
    NB = max(nb_need, 1)
    hmax = max((len(h) for h in halos), default=0)

    # exports and pool positions; H covers both sides: a partition's
    # export set (the union of its importers' needs) can exceed any one
    # partition's import count
    all_halo = np.concatenate(halos) if hmax else np.zeros(0, senders.dtype)
    halo_own = owner(all_halo)
    exports = [np.unique(all_halo[halo_own == p]) for p in range(num_parts)]
    emax = max((len(e) for e in exports), default=0)
    H = max(hmax, emax, 1)
    npp = NI + NB
    pool_pos_of = np.full(n, -1, np.int64)
    for p, exp in enumerate(exports):
        pool_pos_of[exp] = p * H + np.arange(len(exp))

    # LOCAL_OF[g]: the row of node g within its own partition's
    # [interior | boundary] order
    LOCAL_OF = np.zeros(n, np.int32)
    for p in range(num_parts):
        LOCAL_OF[int_rows[p]] = np.arange(len(int_rows[p]), dtype=np.int32)
        LOCAL_OF[bnd_rows[p]] = NI + np.arange(len(bnd_rows[p]), dtype=np.int32)
    # the JAX package's native take_i32: table[mask ? idx : 0], masked
    SLOC = LOCAL_OF[np.where(edge_mask, senders, 0)]

    nodes = np.zeros((num_parts, npp, f), features.dtype)
    pos_ext = np.zeros((num_parts, npp + H, 3), positions.dtype)
    n_mask = np.zeros((num_parts, npp), bool)
    s_int = np.empty((num_parts, NI, k), np.int32)
    m_int = np.zeros((num_parts, NI, k), bool)
    s_bnd = np.empty((num_parts, NB, k), np.int32)
    m_bnd = np.zeros((num_parts, NB, k), bool)
    boundary_idx = np.zeros((num_parts, H), np.int32)
    halo_map = np.zeros((num_parts, H), np.int32)
    gids = np.full((num_parts, npp), -1, np.int32)

    for p in range(num_parts):
        gi, gb, hp = int_rows[p], bnd_rows[p], halos[p]
        cnt_i, cnt_b = len(gi), len(gb)

        nodes[p, :cnt_i] = features[gi]
        nodes[p, NI:NI + cnt_b] = features[gb]
        pos_ext[p, :cnt_i] = positions[gi]
        pos_ext[p, NI:NI + cnt_b] = positions[gb]
        pos_ext[p, npp:npp + len(hp)] = positions[hp]
        n_mask[p, :cnt_i] = True
        n_mask[p, NI:NI + cnt_b] = True
        gids[p, :cnt_i] = gi
        gids[p, NI:NI + cnt_b] = gb

        halo_map[p, :len(hp)] = pool_pos_of[hp]
        exp = exports[p]
        boundary_idx[p, :len(exp)] = LOCAL_OF[exp]

        def remap(rows, pad_idx, allow_remote):
            sd, mk = senders[rows], edge_mask[rows]
            s_loc = SLOC[rows]
            if allow_remote:
                local = mk & (OWNER[rows] == p)
                slot = (np.searchsorted(hp, sd).astype(np.int32) if len(hp)
                        else np.zeros_like(sd, np.int32))
                s_new = np.where(local, s_loc, np.int32(npp) + slot)
            else:
                s_new = s_loc
            out = np.where(mk, s_new, np.int32(pad_idx))
            return out.astype(np.int32, copy=False), mk

        if cnt_i:
            s_int[p, :cnt_i], m_int[p, :cnt_i] = remap(gi, npp, False)
        s_int[p, cnt_i:] = npp
        if cnt_b:
            s_bnd[p, :cnt_b], m_bnd[p, :cnt_b] = remap(gb, npp + H, True)
        s_bnd[p, cnt_b:] = npp + H

    return DensePartitionedGraph(
        num_parts=num_parts, n_interior=NI, n_boundary=NB, halo_cap=H, k=k,
        nodes=nodes, positions_ext=pos_ext, node_mask=n_mask,
        senders_int=s_int, mask_int=m_int, senders_bnd=s_bnd, mask_bnd=m_bnd,
        boundary_idx=boundary_idx, halo_map=halo_map, global_ids=gids,
        rev_int=_rev_table(s_int, m_int, npp), rev_ext=_rev_table(s_bnd, m_bnd, npp + H),
    )
