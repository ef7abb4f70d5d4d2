"""A graph partitioned over P Morton-contiguous ranges, in two layouts.

Counterpart of ``scalable_e3_gnn_tpu/parallel/partition.py``: the COO layout
(``PartitionedGraph``, ``partition_graph``: a receiver-sorted edge list, cut
into local and remote edges) and the fixed-degree one
(``DensePartitionedGraph``, ``partition_graph_dense``).  The octree's Morton
sort makes contiguous node ranges spatially compact, so cutting the sorted
node array into P equal ranges gives partitions with small halos.  Edges are
owned by the receiver's partition; senders on other partitions become halo
slots, filled by the boundary exchange of every layer
(``parallel.halo.exchange_halo``).

Host work, run once per graph topology.  The output is the JAX functions',
array for array and bit for bit.  As in JAX, three passes of the dense
partitioner run through the native helpers of ``data.native_loader`` where that library is built (the
sender pass, the masked gather of local rows, the batched transpose
tables), and through numpy otherwise; both give the same arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..data import native_loader

__all__ = ["PartitionedGraph", "partition_graph", "DensePartitionedGraph",
           "partition_graph_dense", "shared_caps"]


class PartitionedGraph(NamedTuple):
    """COO partition arrays, stacked on axis 0 (one row per partition).

    Index spaces (per partition):
      - local node index: 0..n_per_part-1 (the row in the partition);
        padding rows have node_mask False;
      - extended index: 0..n_per_part+halo_cap-1, local rows then halo
        slots; senders use this space;
      - pool index: 0..P*halo_cap-1, the position in the gathered boundary
        pool; halo_map[p, j] is the pool entry that fills halo slot j.
    The edges are also split into local edges (sender on the partition: their
    messages need no halo, so they run while the exchange is in flight) and
    remote ones (sender in a halo slot).
    """

    num_parts: int
    n_per_part: int
    halo_cap: int
    nodes: np.ndarray  # [P, Np, F] features (Morton-sorted split)
    positions_ext: np.ndarray  # [P, Np + H, 3] local then halo positions
    senders: np.ndarray  # [P, Ep] extended space; pad = Np + H
    receivers: np.ndarray  # [P, Ep] local space, sorted; pad = Np
    edge_mask: np.ndarray  # [P, Ep]
    node_mask: np.ndarray  # [P, Np]
    boundary_idx: np.ndarray  # [P, H] local index of the exported nodes; pad 0
    halo_map: np.ndarray  # [P, H] pool index feeding each halo slot; pad 0
    global_ids: np.ndarray  # [P, Np] input node id; pad -1
    senders_loc: np.ndarray  # [P, El] local space; pad = Np
    receivers_loc: np.ndarray  # [P, El] local space, sorted; pad = Np
    mask_loc: np.ndarray  # [P, El]
    senders_rem: np.ndarray  # [P, Er] extended space (halo slots); pad = Np + H
    receivers_rem: np.ndarray  # [P, Er] local space, sorted; pad = Np
    mask_rem: np.ndarray  # [P, Er]


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


def _rev_table_native(s_blk: np.ndarray, m_blk: np.ndarray, n_targets: int) -> np.ndarray:
    """``_rev_table`` through the native counting scatter: the same table
    (each partition's slots scattered in slot order)."""
    num_parts = s_blk.shape[0]
    tgt = np.ascontiguousarray(s_blk.reshape(num_parts, -1), np.int32)
    mk = native_loader._as_u8(m_blk.reshape(num_parts, -1))
    q = max(max((int(native_loader.rev_counts(tgt[p], mk[p], n_targets).max())
                 for p in range(num_parts)), default=0), 1)
    return native_loader.rev_table_multi(tgt, mk, n_targets, q)


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
    halo_cap: int | None = None,
    interior_cap: int | None = None,
    boundary_cap: int | None = None,
) -> DensePartitionedGraph:
    """Split a dense-K graph into P Morton-contiguous partitions.

    Ownership is by receiver row range; remote senders become halo slots.
    NI, NB and H are ``interior_cap``, ``boundary_cap`` and ``halo_cap`` when
    given (so that the partitions of several clouds share their shapes), else
    what the graph needs, at least 1 each (so no block is empty); a cap below
    the need raises ``ValueError``, as in JAX.  Inputs may be numpy arrays or
    CPU tensors (anything ``np.asarray`` reads)."""
    positions = np.asarray(positions)
    features = np.asarray(features)
    senders = np.asarray(senders)
    edge_mask = np.asarray(edge_mask, bool)
    n, k = senders.shape
    f = features.shape[1]
    npp0 = -(-n // num_parts)  # input rows per partition range
    owner = lambda v: np.minimum(v // npp0, num_parts - 1)
    native = native_loader.available()

    sp = native_loader.sender_pass(senders, edge_mask, npp0, num_parts) if native else None
    if sp is not None:
        OWNER, REMOTE, ROW_REMOTE = sp
    else:
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
    NI = interior_cap if interior_cap is not None else max(ni_need, 1)
    NB = boundary_cap if boundary_cap is not None else max(nb_need, 1)
    if NI < ni_need or NB < nb_need:
        raise ValueError(f"caps ({NI},{NB}) < needed ({ni_need},{nb_need})")
    hmax = max((len(h) for h in halos), default=0)

    # exports and pool positions; H covers both sides: a partition's
    # export set (the union of its importers' needs) can exceed any one
    # partition's import count
    all_halo = np.concatenate(halos) if hmax else np.zeros(0, senders.dtype)
    halo_own = owner(all_halo)
    exports = [np.unique(all_halo[halo_own == p]) for p in range(num_parts)]
    emax = max((len(e) for e in exports), default=0)
    H = halo_cap if halo_cap is not None else max(hmax, emax, 1)
    if H < hmax:
        raise ValueError(f"halo_cap={H} < max needed {hmax}")
    if emax > H:
        raise ValueError(f"export count {emax} exceeds halo_cap {H}")
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
    # table[mask ? idx : 0]
    SLOC = (native_loader.take_i32(LOCAL_OF, senders, edge_mask) if native
            else LOCAL_OF[np.where(edge_mask, senders, 0)])

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

    rev = _rev_table_native if native else _rev_table
    return DensePartitionedGraph(
        num_parts=num_parts, n_interior=NI, n_boundary=NB, halo_cap=H, k=k,
        nodes=nodes, positions_ext=pos_ext, node_mask=n_mask,
        senders_int=s_int, mask_int=m_int, senders_bnd=s_bnd, mask_bnd=m_bnd,
        boundary_idx=boundary_idx, halo_map=halo_map, global_ids=gids,
        rev_int=rev(s_int, m_int, npp), rev_ext=rev(s_bnd, m_bnd, npp + H),
    )


def partition_graph(
    positions: np.ndarray,  # [N, 3] Morton-sorted
    features: np.ndarray,  # [N, F]
    senders: np.ndarray,  # [E] input node ids
    receivers: np.ndarray,  # [E] input node ids, non-decreasing
    edge_mask: np.ndarray,  # [E]
    num_parts: int,
    halo_cap: int | None = None,
    edges_per_part: int | None = None,
    local_edges_per_part: int | None = None,
    remote_edges_per_part: int | None = None,
) -> PartitionedGraph:
    """Split a receiver-sorted COO graph into P Morton-contiguous partitions.

    A partition owns the edges of its receivers.  A stable sort by the
    receiver's partition groups the valid edges into one run per partition
    (each in input order); the halo of a partition is the sorted unique set
    of its remote senders (``np.unique``), the exports of a partition the
    union of the halos it feeds; a remote sender's slot is its
    ``searchsorted`` position in the halo.  The caps (``halo_cap``,
    ``edges_per_part``, ``local_edges_per_part``, ``remote_edges_per_part``)
    pad the arrays to shapes shared by several clouds; a cap below the need
    raises ``ValueError``, as in JAX.  Inputs may be numpy arrays or CPU
    tensors."""
    positions = np.asarray(positions)
    features = np.asarray(features)
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    edge_mask = np.asarray(edge_mask, bool)
    n = positions.shape[0]
    f = features.shape[1]
    npp = -(-n // num_parts)  # nodes per partition (padded)
    owner = lambda v: np.minimum(v // npp, num_parts - 1)

    # the valid edges grouped by their receiver's partition, input order kept
    ve_s = senders[edge_mask]
    ve_r = receivers[edge_mask]
    own_r = owner(ve_r)
    order = np.argsort(own_r, kind="stable")
    ve_s, ve_r, own_r = ve_s[order], ve_r[order], own_r[order]
    own_s = owner(ve_s)
    counts = np.bincount(own_r, minlength=num_parts)
    starts = np.concatenate([[0], np.cumsum(counts)])
    run = lambda a, p: a[starts[p]:starts[p + 1]]

    ep = int(counts.max()) if counts.size else 0
    if edges_per_part is not None:
        if edges_per_part < ep:
            raise ValueError(f"edges_per_part={edges_per_part} < max needed {ep}")
        ep = edges_per_part

    # halos (remote senders, sorted unique) and exports; the automatic cap
    # covers both sides: an export set can exceed any one partition's halo
    halos = [np.unique(run(ve_s, p)[run(own_s, p) != p]) for p in range(num_parts)]
    hmax = max((len(h) for h in halos), default=0)
    all_halo = np.concatenate(halos) if hmax else np.zeros(0, senders.dtype)
    halo_own = owner(all_halo)
    exports = [np.unique(all_halo[halo_own == p]) for p in range(num_parts)]
    emax = max((len(e) for e in exports), default=0)
    if halo_cap is None:
        halo_cap = max(hmax, emax)
    elif halo_cap < hmax:
        raise ValueError(f"halo_cap={halo_cap} < max needed {hmax}")
    H = max(halo_cap, 1)
    if emax > H:
        raise ValueError(f"export count {emax} exceeds halo_cap {H}")
    pool_pos_of = np.full(n, -1, np.int64)
    boundary_idx = np.zeros((num_parts, H), np.int32)
    for p, exp in enumerate(exports):
        boundary_idx[p, :len(exp)] = exp - p * npp  # local index on the owner
        pool_pos_of[exp] = p * H + np.arange(len(exp))

    nodes = np.zeros((num_parts, npp, f), features.dtype)
    pos_ext = np.zeros((num_parts, npp + H, 3), positions.dtype)
    s_arr = np.full((num_parts, ep), npp + H, np.int32)
    r_arr = np.full((num_parts, ep), npp, np.int32)
    e_mask = np.zeros((num_parts, ep), bool)
    n_mask = np.zeros((num_parts, npp), bool)
    halo_map = np.zeros((num_parts, H), np.int32)
    gids = np.full((num_parts, npp), -1, np.int32)

    loc_counts = [int((run(own_s, p) == p).sum()) for p in range(num_parts)]
    el = max(loc_counts, default=0)
    er = max((int(counts[p]) - loc_counts[p] for p in range(num_parts)), default=0)
    if local_edges_per_part is not None:
        if local_edges_per_part < el:
            raise ValueError(f"local_edges_per_part < needed {el}")
        el = local_edges_per_part
    if remote_edges_per_part is not None:
        if remote_edges_per_part < er:
            raise ValueError(f"remote_edges_per_part < needed {er}")
        er = remote_edges_per_part
    sl_arr = np.full((num_parts, max(el, 1)), npp, np.int32)
    rl_arr = np.full((num_parts, max(el, 1)), npp, np.int32)
    ml_arr = np.zeros((num_parts, max(el, 1)), bool)
    sr_arr = np.full((num_parts, max(er, 1)), npp + H, np.int32)
    rr_arr = np.full((num_parts, max(er, 1)), npp, np.int32)
    mr_arr = np.zeros((num_parts, max(er, 1)), bool)

    for p in range(num_parts):
        lo = p * npp
        cnt = max(0, min(npp, n - lo))
        nodes[p, :cnt] = features[lo:lo + cnt]
        pos_ext[p, :cnt] = positions[lo:lo + cnt]
        n_mask[p, :cnt] = True
        gids[p, :cnt] = np.arange(lo, lo + cnt)

        hp = halos[p]
        pos_ext[p, npp:npp + len(hp)] = positions[hp]
        halo_map[p, :len(hp)] = pool_pos_of[hp]

        s, r = run(ve_s, p), run(ve_r, p)
        k = len(s)
        is_loc = run(own_s, p) == p
        # a remote sender's slot: its position in the sorted halo (the
        # values computed for local senders are discarded by the where)
        slot = np.searchsorted(hp, s).astype(np.int64) if len(hp) else np.zeros(k, np.int64)
        s_local = np.where(is_loc, s - lo, npp + slot)
        s_arr[p, :k] = s_local
        r_arr[p, :k] = r - lo
        e_mask[p, :k] = True

        kl = int(is_loc.sum())
        kr = k - kl
        sl_arr[p, :kl] = (s - lo)[is_loc]
        rl_arr[p, :kl] = (r - lo)[is_loc]
        ml_arr[p, :kl] = True
        sr_arr[p, :kr] = s_local[~is_loc]
        rr_arr[p, :kr] = (r - lo)[~is_loc]
        mr_arr[p, :kr] = True

    return PartitionedGraph(
        num_parts=num_parts, n_per_part=npp, halo_cap=H, nodes=nodes, positions_ext=pos_ext,
        senders=s_arr, receivers=r_arr, edge_mask=e_mask, node_mask=n_mask,
        boundary_idx=boundary_idx, halo_map=halo_map, global_ids=gids,
        senders_loc=sl_arr, receivers_loc=rl_arr, mask_loc=ml_arr,
        senders_rem=sr_arr, receivers_rem=rr_arr, mask_rem=mr_arr,
    )


def shared_caps(parts) -> dict:
    """The caps under which each of several clouds' partitions (all of one
    layout, partitioned without caps) partitions again to arrays of the same
    shapes: the largest need of each, as the JAX ``dryrun_multichip`` unifies
    them for its dp stack."""
    if isinstance(parts[0], DensePartitionedGraph):
        return dict(halo_cap=max(p.halo_cap for p in parts),
                    interior_cap=max(p.n_interior for p in parts),
                    boundary_cap=max(p.n_boundary for p in parts))
    return dict(halo_cap=max(p.halo_cap for p in parts),
                edges_per_part=max(p.senders.shape[1] for p in parts),
                local_edges_per_part=max(p.senders_loc.shape[1] for p in parts),
                remote_edges_per_part=max(p.senders_rem.shape[1] for p in parts))
