"""Radius-graph construction on point clouds (fixed K neighbors per node).

Counterpart of ``scalable_e3_gnn_tpu/graph/radius.py``:

- ``radius_graph_brute``: blocked all-pairs distances, exact; the oracle.
- ``radius_graph_cell``: candidates from the 27 stencil cells at the octree
  level whose cell side covers the radius, processed cell-major (one row
  block holds whole cells).  This is the JAX package's direct
  per-candidate-gather branch; its per-cell coordinate table (taken above
  500k points) yields the same edges.  ``row_range=(start, count)`` emits
  only the rows start..start+count, blocked over point rows (the JAX
  package's row-major entry); candidates still come from the whole cloud.
- ``radius_graph_cell_segments``: the JAX package's segmented entry; it
  returns ``radius_graph_cell``'s edges (the cell-major loop already bounds
  its temporaries, so segments buy nothing).

Neighbour selection (``selection``), the nearest ``max_neighbors`` per node:

- ``"sort"``: a stable sort on (d^2, candidate order), so ties break as in
  the JAX package.
- ``"approx"``: the K smallest d^2 by ``torch.topk``.  The JAX package
  calls ``lax.approx_min_k``, approximate on a TPU only; on every other
  backend it returns the exact K smallest keys, and so does this one: its
  recall is 1.0 whatever ``approx_recall`` asks (the argument is accepted
  for compatibility and read nowhere).  The order among keys that tie at
  the K-th is not stable, as JAX's is not.
- ``"approx2"`` (cell-major only; the row-major entry maps it to
  ``"approx"`` on exact d^2, as JAX does): the same selection on JAX's
  recentred bf16 keys, from the per-cell coordinate table
  (``_cell_point_table``: invalid slots 1e9, empty receiver slots zeroed),
  coordinates relative to the first receiver slot of each cell, scaled by
  1/(4r) and rounded to bf16; the cross term summed in fp32 from the bf16
  values (products of two bf16 values are exact in fp32), the cutoff 0.25
  in the scaled space.  Only the choice of neighbours uses these keys.

All emit a receiver-sorted COO with a validity mask.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.device import as_tensor, resolve_device
from .morton import BITS, CODE_SENTINEL, _compact1by2, _part1by2
from .octree import Octree

__all__ = [
    "RadiusEdges",
    "radius_graph_brute",
    "radius_graph_cell",
    "radius_graph_cell_segments",
    "search_level_for_radius",
    "suggest_cell_capacity",
    "symmetrize_dense",
]

_INT_MAX = 2**31 - 1
# d^2 entries (cell rows x candidates) handled per step of the cell-major loop
_CELL_STEP_ELEMS = 1 << 27


def suggest_cell_capacity(
    tree: Octree,
    radius: float,
    lo: Tuple[float, float, float],
    hi: Tuple[float, float, float],
    round_to: int = 8,
) -> int:
    """Max occupancy of the search level, rounded up to ``round_to``."""
    level = min(search_level_for_radius(radius, lo, hi), tree.num_levels - 1)
    occ = int(tree.cell_count[level].max())
    return max(round_to, -(-occ // round_to) * round_to)


class RadiusEdges(NamedTuple):
    senders: torch.Tensor  # [N*K] int32 (N on padding)
    receivers: torch.Tensor  # [N*K] int32, non-decreasing
    mask: torch.Tensor  # [N*K] bool
    num_edges: torch.Tensor  # [] int32, number of valid edges


_SELECTIONS = ("sort", "approx", "approx2")


def _check_selection(selection: str) -> None:
    if selection not in _SELECTIONS:
        raise ValueError(f"unknown selection {selection!r}")


def _topk_neighbors(d2, cand_idx, valid, radius, self_idx, k, selection="sort"):
    """Nearest-k among masked candidates: d2/cand_idx/valid [rows, M] ->
    senders [rows, k] (INT_MAX where empty), mask [rows, k].  ``selection``
    "sort": a stable sort; "approx": ``torch.topk`` (exact, ties unstable)."""
    ok = valid & (d2 <= radius * radius) & (cand_idx != self_idx[:, None])
    key = torch.where(ok, d2, torch.full_like(d2, math.inf))
    if selection == "approx":
        skey, order = torch.topk(key, k, dim=1, largest=False, sorted=True)
    else:
        skey, order = torch.sort(key, dim=1, stable=True)
        skey, order = skey[:, :k], order[:, :k]
    senders = torch.gather(cand_idx, 1, order)
    mask = torch.isfinite(skey)
    return torch.where(mask, senders, _INT_MAX).to(torch.int32), mask


def _edges_from_slots(senders, mask, n, k) -> RadiusEdges:
    senders = senders.reshape(-1)[: n * k]
    mask = mask.reshape(-1)[: n * k]
    receivers = torch.arange(n, dtype=torch.int32, device=senders.device).repeat_interleave(k)
    senders = torch.where(mask, senders, n).to(torch.int32)
    return RadiusEdges(senders, receivers, mask, mask.sum().to(torch.int32))


def radius_graph_brute(
    points,
    radius: float,
    max_neighbors: int,
    block_size: int = 1024,
    device=None,
) -> RadiusEdges:
    """Exact radius graph by blocked all-pairs distances (O(N^2))."""
    points = as_tensor(points, resolve_device(device))
    n = points.shape[0]
    k = max_neighbors
    nb = -(-n // block_size)
    npad = nb * block_size
    pts_pad = torch.cat(
        [points, torch.full((npad - n, 3), math.inf, dtype=points.dtype, device=points.device)]
    )
    sq = torch.sum(points * points, dim=-1)  # [N]
    cand_row = torch.arange(n, dtype=torch.int32, device=points.device)[None, :]
    senders, masks = [], []
    for b in range(nb):
        rows = pts_pad[b * block_size : (b + 1) * block_size]
        row_idx = b * block_size + torch.arange(block_size, dtype=torch.int32, device=points.device)
        # d^2 = |p|^2 + |q|^2 - 2 p.q ; the cross term is one [B,3]x[3,N] product
        d2 = torch.sum(rows * rows, dim=-1)[:, None] + sq[None, :] - 2.0 * (rows @ points.T)
        d2 = torch.clamp(d2, min=0.0)
        cand = cand_row.expand(block_size, n)
        valid = (row_idx < n)[:, None].expand(block_size, n)
        s, m = _topk_neighbors(d2, cand, valid, radius, row_idx, k)
        senders.append(s)
        masks.append(m)
    return _edges_from_slots(torch.cat(senders), torch.cat(masks), n, k)


def symmetrize_dense(senders: torch.Tensor, mask: torch.Tensor):
    """Drop one-sided edges of a fixed-K list; compute reverse-edge slots.

    Returns ``(mutual_mask [N,K], reverse_slot [N,K])``: reverse_slot[v, k]
    is the flat slot (in [N*K]) of the edge pointing back from v's k-th
    sender to v, or N*K where the edge is not mutual.
    """
    n, k = senders.shape
    s = torch.clamp(senders, max=n - 1).long()
    nbr_of_nbr = senders[s]  # [N, K, K]
    nbr_valid = mask[s]  # [N, K, K]
    me = torch.arange(n, dtype=senders.dtype, device=senders.device)[:, None, None]
    eq = (nbr_of_nbr == me) & nbr_valid
    found = eq.any(dim=-1)
    kprime = torch.argmax(eq.to(torch.uint8), dim=-1)  # first match
    mutual = mask & found
    reverse_slot = torch.where(mutual, s * k + kprime, n * k)
    return mutual, reverse_slot.to(torch.int32)


def search_level_for_radius(
    radius: float, lo: Tuple[float, float, float], hi: Tuple[float, float, float]
) -> int:
    """Deepest octree level whose cell side still covers the search radius."""
    extent = max(h - l for h, l in zip(hi, lo))
    lvl = int(math.floor(math.log2(max(extent / radius, 1.0))))
    return max(0, min(lvl, BITS))


def _stencil(device):
    r = (-1, 0, 1)
    return torch.tensor(
        [[dx, dy, dz] for dx in r for dy in r for dz in r], dtype=torch.int32, device=device
    )  # [27, 3]


def _stencil_lookup(level_codes, cell_code, cell_start, cell_count, level):
    """27-cell stencil of level-prefix codes [R] -> (start, count, pos) [R, 27]
    in the level's sorted cell table."""
    grid_max = (1 << level) - 1
    cap = cell_code.shape[0]
    st = _stencil(level_codes.device)
    gx = _compact1by2(level_codes >> 2)
    gy = _compact1by2(level_codes >> 1)
    gz = _compact1by2(level_codes)
    nx, ny, nz = gx[:, None] + st[:, 0], gy[:, None] + st[:, 1], gz[:, None] + st[:, 2]
    in_box = ((nx >= 0) & (nx <= grid_max) & (ny >= 0) & (ny <= grid_max)
              & (nz >= 0) & (nz <= grid_max))
    clip = lambda v: torch.clamp(v, 0, grid_max)
    ncode = (_part1by2(clip(nx)) << 2) | (_part1by2(clip(ny)) << 1) | _part1by2(clip(nz))
    pos = torch.searchsorted(cell_code, ncode.to(torch.int32).contiguous())
    pos = torch.clamp(pos, max=cap - 1)
    found = (cell_code[pos] == ncode) & in_box
    start = cell_start[pos]
    count = torch.where(found, cell_count[pos], 0)
    return start, count, pos.to(torch.int32)


def _resolve_level(tree, radius, lo, hi, level):
    if level is None:
        level = search_level_for_radius(radius, lo, hi)
    return min(level, tree.num_levels - 1)


def radius_graph_cell(
    tree: Octree,
    radius: float,
    lo: Tuple[float, float, float],
    hi: Tuple[float, float, float],
    max_neighbors: int,
    cell_capacity: int = 64,
    level: Optional[int] = None,
    block_size: int = 1024,
    row_range: Optional[Tuple[int, int]] = None,
    selection: str = "sort",
    approx_recall: float = 0.95,
) -> RadiusEdges:
    """Radius graph from octree cells; indices are in *sorted* point space.

    Runs on the tree's device.  ``cell_capacity`` must cover the max
    occupancy of the search level (``suggest_cell_capacity``); overflowing
    cells are truncated to their first ``cell_capacity`` points, as
    candidates and (cell-major) as receivers.  ``block_size`` sets the cell
    padding as in the JAX package (whole blocks of ``block_size //
    cell_capacity`` cells), and the rows per block of the row-major entry.
    ``row_range=(start, count)`` emits the edges of the sorted points
    start..start+count only (``count * K`` slots).  ``selection`` and
    ``approx_recall``: the module docstring.
    """
    _check_selection(selection)
    if row_range is not None:
        return _radius_graph_row_major(tree, radius, lo, hi, max_neighbors, cell_capacity,
                                       level, block_size, row_range, selection)
    senders_cs, mask_cs = _cell_major_slots(
        tree, radius, lo, hi, max_neighbors, cell_capacity, level, block_size, selection
    )
    return _compact_cell_slots(tree, radius, lo, hi, max_neighbors, cell_capacity,
                               level, senders_cs, mask_cs)


def radius_graph_cell_segments(
    tree: Octree,
    radius: float,
    lo: Tuple[float, float, float],
    hi: Tuple[float, float, float],
    max_neighbors: int,
    cell_capacity: int = 64,
    level: Optional[int] = None,
    block_size: int = 1024,
    num_segments: int = 8,
    selection: str = "sort",
    approx_recall: float = 0.95,
) -> RadiusEdges:
    """The JAX package's cell-segmented entry for clouds of millions of
    points: ``radius_graph_cell``'s edges.  There the segments bound the
    size of one compiled program; here ``_cell_major_slots`` already walks
    the cells in steps of bounded size, so ``num_segments`` changes nothing
    and is accepted for compatibility."""
    if num_segments < 1:
        raise ValueError(f"num_segments must be >= 1, got {num_segments}")
    return radius_graph_cell(tree, radius, lo, hi, max_neighbors, cell_capacity, level,
                             block_size, selection=selection, approx_recall=approx_recall)


def _cell_point_table(tree, cap, level, pad_cells):
    """Cap-padded per-cell coordinate table [C + pad_cells, cap, 3] of the
    level's C cells: slot o of cell c holds its o-th point, invalid slots
    (past the count, and the padding cells) the 1e9 sentinel."""
    n = tree.num_points
    cell_start = tree.cell_start[level]
    cell_count = tree.cell_count[level]
    slot = torch.arange(cap, dtype=torch.int32, device=cell_start.device)
    idx = torch.clamp(cell_start[:, None] + slot, 0, n - 1).long()
    tab = tree.points[idx]
    tab = torch.where((slot < cell_count[:, None])[..., None], tab, 1e9)
    return torch.cat([tab, tab.new_full((pad_cells, cap, 3), 1e9)])


def _approx2_d2(rpts, cpts, radius):
    """JAX's recentred bf16 keys: ``rpts`` [c, cap, 3], ``cpts`` [c, M, 3]
    from the cell table -> d^2 [c, cap, M] in the space scaled by 1/(4r),
    the centre each cell's first receiver slot.  Each product of two bf16
    values is exact in fp32; the three are summed in fp32."""
    s = torch.tensor(1.0 / (4.0 * radius), dtype=torch.float32)
    ctr = rpts[:, :1, :]
    rb = ((rpts - ctr) * s).to(torch.bfloat16).float()
    qb = ((cpts - ctr) * s).to(torch.bfloat16).float()
    rq = torch.bmm(rb, qb.transpose(1, 2))
    r2 = torch.sum(rb * rb, dim=-1)
    q2 = torch.sum(qb * qb, dim=-1)
    return torch.clamp(r2[..., None] + q2[:, None, :] - 2.0 * rq, min=0.0)


def _cell_major_slots(tree, radius, lo, hi, max_neighbors, cell_capacity, level,
                      block_size, selection="sort"):
    """Nearest-K selection for all cells, in cell-slot space.

    Returns (senders [C*cap, K], mask [C*cap, K]) where slot row c*cap+o is
    the o-th point of cell c (C = cells padded to whole blocks).  Rows are
    independent, so cells are processed in steps of bounded size.
    """
    n = tree.num_points
    k = max_neighbors
    cap = cell_capacity
    level = _resolve_level(tree, radius, lo, hi, level)
    pts = tree.points
    dev = pts.device
    cell_code = tree.cell_code[level]
    cell_start = tree.cell_start[level]
    cell_count = tree.cell_count[level]
    capc = cell_code.shape[0]
    cb = max(1, block_size // cap)  # cells per block
    nb = -(-capc // cb)
    pad_c = nb * cb - capc
    i32 = dict(dtype=torch.int32, device=dev)
    code_p = torch.cat([cell_code, torch.full((pad_c,), int(CODE_SENTINEL), **i32)])
    start_p = torch.cat([cell_start, torch.full((pad_c,), n, **i32)])
    count_p = torch.cat([cell_count, torch.zeros((pad_c,), **i32)])
    slot = torch.arange(cap, **i32)
    celltab = _cell_point_table(tree, cap, level, pad_c) if selection == "approx2" else None

    step = max(1, _CELL_STEP_ELEMS // (cap * 27 * cap))
    senders, masks = [], []
    for c0 in range(0, nb * cb, step):
        ccode, cstart, ccount = (a[c0 : c0 + step] for a in (code_p, start_p, count_p))
        c = ccode.shape[0]
        nstart, ncount, npos = _stencil_lookup(ccode, cell_code, cell_start, cell_count, level)
        cand = nstart[..., None] + slot  # [c, 27, cap]
        cvalid = slot < ncount[..., None]
        candf = torch.where(cvalid, cand, 0).reshape(c, 27 * cap)
        cvalidf = cvalid.reshape(c, 27 * cap)
        rows_idx = cstart[:, None] + slot  # [c, cap]
        rvalid = slot < ccount[:, None]
        r_eff = radius
        if celltab is not None:
            cpts = celltab[npos.long()].reshape(c, 27 * cap, 3)  # whole-cell rows
            rpts = torch.where(rvalid[..., None], celltab[c0 : c0 + c], 0.0)
            d2 = _approx2_d2(rpts, cpts, radius)
            r_eff = 0.25  # radius * 1/(4r) in the scaled space
        else:
            cpts = pts[candf.long()]  # [c, 27*cap, 3]
            rpts = pts[torch.where(rvalid, rows_idx, 0).long()]  # [c, cap, 3]
            # d^2 = |r|^2 + |q|^2 - 2 r.q ; the cross term is one batched product
            rq = torch.bmm(rpts, cpts.transpose(1, 2))  # [c, cap, 27*cap]
            r2 = torch.sum(rpts * rpts, dim=-1)
            q2 = torch.sum(cpts * cpts, dim=-1)
            d2 = torch.clamp(r2[..., None] + q2[:, None, :] - 2.0 * rq, min=0.0)
        valid = (cvalidf[:, None, :] & rvalid[..., None]).reshape(c * cap, 27 * cap)
        s, m = _topk_neighbors(
            d2.reshape(c * cap, 27 * cap),
            candf[:, None, :].expand(c, cap, 27 * cap).reshape(c * cap, 27 * cap),
            valid, r_eff, rows_idx.reshape(c * cap), k,
            "approx" if selection == "approx2" else selection,
        )
        senders.append(s)
        masks.append(m)
    return torch.cat(senders), torch.cat(masks)


def _radius_graph_row_major(tree, radius, lo, hi, max_neighbors, cell_capacity, level,
                            block_size, row_range, selection) -> RadiusEdges:
    """The rows start..start+count of the cell graph, blocked over point
    rows: each row's 27 stencil cells from its own code at the level."""
    n = tree.num_points
    k = max_neighbors
    cap = cell_capacity
    row_start, row_count = (int(v) for v in row_range)
    level = _resolve_level(tree, radius, lo, hi, level)
    cshift = 3 * (BITS - level)  # full code -> level prefix
    pts = tree.points
    dev = pts.device
    cell_code = tree.cell_code[level]
    cell_start = tree.cell_start[level]
    cell_count = tree.cell_count[level]
    # approx2's bf16 keys are cell-major only: here the approx selection on exact d^2
    sel = "approx" if selection == "approx2" else selection
    slot = torch.arange(cap, dtype=torch.int32, device=dev)
    stop = min(n, row_start + row_count)
    bs = max(1, min(block_size, _CELL_STEP_ELEMS // (27 * cap)))
    senders, masks = [], []
    for b0 in range(row_start, row_start + row_count, bs):
        row_idx = torch.arange(b0, b0 + bs, dtype=torch.int32, device=dev)
        rvalid = row_idx < stop
        ri = torch.where(rvalid, row_idx, 0).long()
        rows = pts[ri]  # [B, 3]
        start, count, _ = _stencil_lookup(tree.codes[ri] >> cshift, cell_code, cell_start,
                                          cell_count, level)  # [B, 27]
        cand = start[..., None] + slot  # [B, 27, cap]
        cvalid = slot < count[..., None]
        cand = torch.where(cvalid, cand, 0).reshape(bs, 27 * cap)
        cpts = pts[cand.long()]  # [B, 27*cap, 3]
        rq = torch.bmm(cpts, rows[:, :, None])[..., 0]  # [B, 27*cap]
        r2 = torch.sum(rows * rows, dim=-1)
        q2 = torch.sum(cpts * cpts, dim=-1)
        d2 = torch.clamp(r2[:, None] + q2 - 2.0 * rq, min=0.0)
        valid = cvalid.reshape(bs, 27 * cap) & rvalid[:, None]
        s, m = _topk_neighbors(d2, cand, valid, radius, row_idx, k, sel)
        senders.append(s)
        masks.append(m)
    senders = torch.cat(senders).reshape(-1)[: row_count * k]
    mask = torch.cat(masks).reshape(-1)[: row_count * k]
    receivers = (row_start + torch.arange(row_count, dtype=torch.int32, device=dev)
                 ).repeat_interleave(k)
    senders = torch.where(mask, senders, n).to(torch.int32)
    return RadiusEdges(senders, receivers, mask, mask.sum().to(torch.int32))


def _compact_cell_slots(tree, radius, lo, hi, max_neighbors, cell_capacity, level,
                        senders_cs, mask_cs) -> RadiusEdges:
    """Cell-slot results [>=capc*cap, K] -> point-row RadiusEdges."""
    n = tree.num_points
    k = max_neighbors
    cap = cell_capacity
    level = _resolve_level(tree, radius, lo, hi, level)
    nslots = senders_cs.shape[0]
    rank = tree.point_cell[level]
    dev = rank.device
    pidx = torch.arange(n, dtype=torch.int32, device=dev)
    flags = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), rank[1:] != rank[:-1]])
    run_start = torch.cummax(torch.where(flags, pidx, -1), 0).values
    pslot = rank * cap + (pidx - run_start)
    # points past an overflowing cell's capacity keep no edges
    pslot = torch.where((pidx - run_start) < cap, pslot, nslots).long()
    s_pad = torch.cat([senders_cs, torch.zeros((1, k), dtype=senders_cs.dtype, device=dev)])
    m_pad = torch.cat([mask_cs, torch.zeros((1, k), dtype=torch.bool, device=dev)])
    return _edges_from_slots(s_pad[pslot], m_pad[pslot], n, k)
