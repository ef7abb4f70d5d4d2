"""Hierarchical octree over point clouds: one sort plus per-level scans.

Counterpart of ``scalable_e3_gnn_tpu/graph/octree.py::build_octree``.  Points
are quantized, Morton-encoded and sorted once; every octree cell at every
level is then a contiguous run of the sorted array, recovered with
prefix-change flags and cumulative sums.  Per-level arrays are padded to
min(8^level, N) entries, exactly as in the JAX package, so the two builds can
be compared array for array.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from ..utils.device import as_tensor, resolve_device
from .morton import BITS, CODE_SENTINEL, morton_encode_points

__all__ = ["Octree", "build_octree"]

_SENT = int(CODE_SENTINEL)


class Octree(NamedTuple):
    """Padded level-by-level octree over a Morton-sorted point cloud.

    "Per level" fields are tuples with one tensor per level (level 0 = the
    root cell).  Cells are dense-ranked in Morton order; padding entries carry
    count 0 and code CODE_SENTINEL.
    """

    points: torch.Tensor  # [N, 3] sorted by Morton code
    order: torch.Tensor  # [N] original index of sorted point i
    codes: torch.Tensor  # [N] sorted Morton codes
    point_cell: Tuple[torch.Tensor, ...]  # [L][N] dense cell rank per point
    cell_start: Tuple[torch.Tensor, ...]  # [L][C_l] first sorted-point index
    cell_count: Tuple[torch.Tensor, ...]  # [L][C_l] points in cell
    cell_code: Tuple[torch.Tensor, ...]  # [L][C_l] Morton prefix (pad=SENTINEL)
    num_cells: Tuple[torch.Tensor, ...]  # [L][] cell count
    leaf_level: torch.Tensor  # [N] first level where the point's cell <= leaf_size

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def num_levels(self) -> int:
        return len(self.point_cell)


def _level_cap(level: int, n: int) -> int:
    return int(min(8**level, n))


def _cumrank(flags: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(flags.to(torch.int32), 0, dtype=torch.int32) - 1


def build_octree(
    points,
    lo: Tuple[float, float, float],
    hi: Tuple[float, float, float],
    num_levels: int = 6,
    leaf_size: int = 32,
    device=None,
) -> Octree:
    """Construct the padded octree of ``points`` [N, 3] (numpy or tensor).

    ``lo``/``hi`` are the domain bounds; level l cells have side
    (hi-lo)/2^l; ``leaf_level`` is the first level at which a point's cell
    holds <= ``leaf_size`` points (capped at the deepest level).
    """
    if not (1 <= num_levels <= BITS + 1):
        raise ValueError(f"num_levels must be in [1, {BITS + 1}]")
    dev = resolve_device(device)
    points = as_tensor(points, dev)
    n = points.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    codes = morton_encode_points(points, lo, hi)
    # stable sort by code; the coordinates and original indices follow
    codes_s, order = torch.sort(codes, stable=True)
    pts_s = points[order]
    order = order.to(torch.int32)

    pidx = torch.arange(n, **i32)
    one = torch.ones((1,), dtype=torch.bool, device=dev)

    def _runs(vals, starts, flags, cap):
        """Compress flagged runs into padded cell arrays (trash-row scatter)."""
        rank = _cumrank(flags)
        ids = torch.where(flags, rank, cap + 1).long()
        start_full = torch.full((cap + 2,), n, **i32)
        start_full.index_put_((ids,), starts)
        start = start_full[:cap]
        count = start_full[1 : cap + 1] - start
        code_full = torch.full((cap + 1,), _SENT, **i32)
        code_full.index_put_((torch.where(flags, rank, cap).long(),), vals)
        return rank, start, count, code_full[:cap]

    # adjacent sorted codes start a new level-l cell iff they differ above
    # bit 3*(BITS-l)
    d = codes_s[1:] ^ codes_s[:-1] if n > 1 else torch.zeros((0,), **i32)

    point_cell: List[torch.Tensor] = []
    num_cells: List[torch.Tensor] = []
    leaf_acc = torch.zeros((n,), **i32)
    for level in range(num_levels):
        shift = 3 * (BITS - level)
        flags = torch.cat([one, (d >> shift) != 0])
        rank = _cumrank(flags)
        point_cell.append(rank)
        num_cells.append(rank[-1] + 1)
        # cell count = next run start - own run start, both from scans
        run_start = torch.cummax(torch.where(flags, pidx, -1), 0).values
        g = torch.where(flags, pidx, n)
        rev_min = torch.flip(torch.cummin(torch.flip(g, (0,)), 0).values, (0,))
        next_start = torch.cat([rev_min[1:], torch.full((1,), n, **i32)])
        leaf_acc = leaf_acc + (next_start - run_start > leaf_size).to(torch.int32)
    leaf_level = torch.clamp(leaf_acc, max=num_levels - 1).to(torch.int32)

    # deepest-level cells: run starts compacted by a sort of flagged ranks
    deepest = num_levels - 1
    shift_L = 3 * (BITS - deepest)
    flags_L = torch.cat([one, (d >> shift_L) != 0])
    cap_L = _level_cap(deepest, n)
    rank_L = point_cell[deepest]
    keys = torch.where(flags_L, rank_L, 2**31 - 1)
    _, korder = torch.sort(keys, stable=True)
    start_L = pidx[korder][:cap_L]
    valid_L = torch.arange(cap_L, **i32) < num_cells[deepest]
    start_L = torch.where(valid_L, start_L, n)
    nxt = torch.cat([start_L[1:], torch.full((1,), n, **i32)])
    count_L = torch.where(valid_L, nxt - start_L, 0)
    code_L = torch.where(
        valid_L, codes_s[torch.clamp(start_L, max=n - 1).long()] >> shift_L, _SENT
    ).to(torch.int32)

    # coarser cells from the next-deeper level's cell arrays
    cell_start: List[torch.Tensor] = [start_L]
    cell_count: List[torch.Tensor] = [count_L]
    cell_code: List[torch.Tensor] = [code_L]
    child_code, child_start = code_L, start_L
    for level in range(deepest - 1, -1, -1):
        child_real = child_code != _SENT
        dc = (child_code[1:] ^ child_code[:-1] if child_code.shape[0] > 1
              else torch.zeros((0,), **i32))
        flags_c = torch.cat([one[: min(1, child_code.shape[0])], (dc >> 3) != 0]) & child_real
        cap = _level_cap(level, n)
        _, start, count, code_arr = _runs(
            torch.where(child_real, child_code >> 3, _SENT).to(torch.int32),
            child_start, flags_c, cap,
        )
        cell_start.insert(0, start)
        cell_count.insert(0, count)
        cell_code.insert(0, code_arr)
        child_code, child_start = code_arr, start

    return Octree(
        points=pts_s,
        order=order,
        codes=codes_s,
        point_cell=tuple(point_cell),
        cell_start=tuple(cell_start),
        cell_count=tuple(cell_count),
        cell_code=tuple(cell_code),
        num_cells=tuple(num_cells),
        leaf_level=leaf_level,
    )
