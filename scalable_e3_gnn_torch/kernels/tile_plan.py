"""The nonzero tiles of the CG-folded weights, for the generic message
kernels' tensor-core engine (``csrc/generic_mma.cuh``).

The folded weight ``W'_l`` [A*C1, D] of a message layer is nonzero only where
a CG path and coefficient exist, so most of the engine's ``mma.sync`` tiles
multiply zeros.  A plan lists, per layer and attribute component c, the 16x8
tiles of ``W'_l[c]`` that hold any structural nonzero, for the two products
the kernels run:

- the forward GEMM ``y += m @ W[c]``: B tiles of 16 rows of C1 (a k-step
  ``ks``) by 8 columns of D (an n-tile ``nt``); a mask per (c, ks) over nt;
- the dm GEMM ``dm += dya @ W[c]^T``: B tiles of 16 rows of D (a k-step
  ``ds``) by 8 columns of C1 (``ct``); a mask per (c, ds) over ct.

The engine walks each GEMM's output columns in blocks of ``FWD_BLOCK``
n-tiles (128 columns of D) or ``DM_BLOCK`` (192 columns of C1), so its
register arrays keep one size at any width: the kernels' masks are per
(block, c, outer) over the block's inner tiles (``block_masks``), and a
stream lists its tiles block by block.  At D <= 128 and C1 <= 192 there is
one block, and the masks and streams are the unblocked ones.

``pack`` gathers the listed tiles of the weights into one contiguous run per
GEMM (a stream), each tile 128 values in the order the engine's lanes read
their B fragments (lane L = 4 g + t: ``b0 = B[2t, g], B[2t+1, g]``, ``b1 =
B[2t+8, g], B[2t+9, g]``), through a gather index built once; a call costs
one gather and no host sync.  ``chunk_table`` cuts the streams into the
engine's bulk copies: at most ``CHUNK_TILES`` tiles, whole rows (the tiles of
one mask) each, a stream's first chunk starting fresh; ``args`` hands the
engine each stream's first chunk, then the chunk table, in one device array.
A plan serves any number of message layers (one forward and one dm stream
each).  Skipping a zero tile
adds exactly 0 to an fp32 accumulator, so the engine's outputs are bitwise
those of the dense product.

The plan comes from the fold's structure: the layers' fold at seeded random
parameters (no cancellation can hide a path; ``TensorProduct`` never gives an
entry of ``W'`` two terms).  ``dense`` lists every tile: it serves weights of
unknown structure with the same engine.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["TilePlan", "fold_structure", "CHUNK_TILES", "FWD_BLOCK", "DM_BLOCK", "fwd_blocks",
           "dm_blocks"]

CHUNK_TILES = 64  # tiles per bulk copy of the engine's ring (csrc/generic_mma.cuh kChunk)
FWD_BLOCK = 16  # forward n-tiles per column block (csrc/generic_mma.cuh kBlockNT)
DM_BLOCK = 24  # dm n-tiles per column block (kBlockCT)


def fwd_blocks(d: int) -> int:
    """Column blocks of a layer's forward GEMM (over D)."""
    return -(-d // (8 * FWD_BLOCK))


def dm_blocks(c1: int) -> int:
    """Column blocks of a layer's dm GEMM (over C1)."""
    return -(-c1 // (8 * DM_BLOCK))


def _fwd_index(a: int, c1: int, d: int) -> np.ndarray:
    """[A, KS, NT, 128] flat positions in W' [A*C1, D] of every forward tile's
    values in fragment order, -1 past the edges."""
    ks_n, nt_n = -(-c1 // 16), -(-d // 8)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    e = np.arange(4)
    kk = (2 * t[:, None] + (e % 2)[None, :] + 8 * (e // 2)[None, :]).reshape(-1)  # [128]
    nn = np.repeat(g, 4)
    c = np.arange(a)[:, None, None, None]
    k = np.arange(ks_n)[None, :, None, None] * 16 + kk[None, None, None, :]
    n = np.arange(nt_n)[None, None, :, None] * 8 + nn[None, None, None, :]
    flat = (c * c1 + k) * d + n
    return np.where((k < c1) & (n < d), flat, -1)


def _dm_index(a: int, c1: int, d: int) -> np.ndarray:
    """[A, DS, CT, 128] flat positions in W' of every dm tile (B = W[c]^T:
    16 rows of D, 8 columns of C1) in fragment order, -1 past the edges."""
    ct_n, ds_n = -(-c1 // 8), -(-d // 16)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    e = np.arange(4)
    dd = (2 * t[:, None] + (e % 2)[None, :] + 8 * (e // 2)[None, :]).reshape(-1)
    cc = np.repeat(g, 4)
    c = np.arange(a)[:, None, None, None]
    row = np.arange(ds_n)[None, :, None, None] * 16 + dd[None, None, None, :]
    col = np.arange(ct_n)[None, None, :, None] * 8 + cc[None, None, None, :]
    flat = (c * c1 + col) * d + row
    return np.where((col < c1) & (row < d), flat, -1)


def _listed(index: np.ndarray, nonzero: np.ndarray) -> np.ndarray:
    """Which tiles of a tile index [..., 128] hold a structural nonzero of
    the flat map ``nonzero`` (bool [...])."""
    nz = np.append(nonzero.reshape(-1), False)
    return nz[index].any(axis=-1)  # -1 reads the appended False


def _bits(listed: np.ndarray) -> np.ndarray:
    """uint32 bit masks over the last axis (at most 32 tiles) of a bool
    array."""
    return (listed.astype(np.uint64) << np.arange(listed.shape[-1], dtype=np.uint64)).sum(
        axis=-1).astype(np.uint32)


def _blocked(index: np.ndarray, block: int) -> np.ndarray:
    """A tile index [A, outer, inner, 128] cut into column blocks of ``block``
    inner tiles: [blocks, A, outer, block, 128], -1 past the last tile."""
    a, outer, inner, v = index.shape
    nb = -(-inner // block)
    pad = np.full((a, outer, nb * block - inner, v), -1, index.dtype)
    return np.concatenate([index, pad], axis=2).reshape(a, outer, nb, block, v).transpose(
        2, 0, 1, 3, 4)


def fold_structure(layers: Sequence, perms: Sequence, seed: int = 0) -> list:
    """Per message layer the nonzero map [A*C1, D] of its folded weights with
    the gate's column permutation: the fold of seeded random parameters
    (``TensorProduct._fold_plan``: positions, sources, coefficients)."""
    rng = np.random.default_rng(seed)
    out = []
    for layer, perm in zip(layers, perms):
        tp = layer.tp
        wf = np.zeros(tp._gemm_z * tp.out_dim, np.float64)
        for name in sorted(tp._fold_plan):
            tgt, src, coef = tp._fold_plan[name]
            w = rng.standard_normal(int(np.prod(tp._w_shapes[name])))
            np.add.at(wf, tgt, coef.astype(np.float64) * w[src])
        out.append(wf.reshape(tp._gemm_z, tp.out_dim)[:, np.asarray(perm)] != 0)
    return out


class TilePlan:
    """The listed tiles of a message block's layers and their gather index.

    ``nonzero``: per layer the bool map [A*C1, D] of W' (``fold_structure``),
    or None for every tile (``TilePlan.dense``)."""

    def __init__(self, a: int, widths: Sequence[Tuple[int, int]],
                 nonzero: Optional[Sequence[np.ndarray]] = None) -> None:
        self.a = a
        self.widths = tuple((int(c1), int(d)) for c1, d in widths)
        self._streams = {}
        self.block_masks: Dict[tuple, np.ndarray] = {}
        for i, (c1, d) in enumerate(self.widths):
            nz = np.ones((a * c1, d), bool) if nonzero is None else np.asarray(nonzero[i], bool)
            if nz.shape != (a * c1, d):
                raise ValueError(f"layer {i}: nonzero map {nz.shape}, wants {(a * c1, d)}")
            for kind, index, block in (("fwd", _fwd_index(a, c1, d), FWD_BLOCK),
                                       ("dm", _dm_index(a, c1, d), DM_BLOCK)):
                bidx = _blocked(index, block)
                listed = _listed(bidx, nz)  # [blocks, A, outer, block]
                self.block_masks[(kind, i)] = _bits(listed)
                tiles = bidx[listed]  # [ntiles, 128] in (block, c, outer, inner) order
                self._streams[(kind, i, False)] = tiles
                if kind == "dm":  # the vjp walks each block's components last first
                    per = listed.reshape(listed.shape[0], a, -1).sum(axis=2)
                    runs = np.split(tiles, np.cumsum(per.reshape(-1))[:-1])
                    order = [b * a + c for b in range(per.shape[0]) for c in range(a - 1, -1, -1)]
                    self._streams[(kind, i, True)] = np.concatenate([runs[j] for j in order])
        self._dev: Dict[tuple, torch.Tensor] = {}

    @classmethod
    def dense(cls, a: int, widths: Sequence[Tuple[int, int]]) -> "TilePlan":
        return cls(a, widths, None)

    def counts(self, kind: str) -> Tuple[int, ...]:
        """Listed tiles per layer of one GEMM ("fwd" or "dm")."""
        return tuple(len(self._streams[(kind, i, False)]) for i in range(len(self.widths)))

    def index(self, streams: Sequence[Tuple[str, int, bool]]) -> np.ndarray:
        """The flat gather index [tiles * 128] of the named streams one after
        the other, positions in the concatenation of the flattened weights
        (layer 1's first), -1 for a zero."""
        base = [0]
        for c1, d in self.widths:
            base.append(base[-1] + self.a * c1 * d)
        parts = []
        for kind, i, rev in streams:
            t = self._streams[(kind, i, rev)]
            parts.append(np.where(t >= 0, t + base[i], -1).reshape(-1))
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    def _rows(self, kind: str, i: int, rev: bool) -> np.ndarray:
        """Listed tiles of each row of a stream, in the engine's order (each
        block's components last first for the vjp)."""
        masks = self.block_masks[(kind, i)]
        counts = np.vectorize(lambda m: bin(int(m)).count("1"), otypes=[np.int64])(masks)
        return (counts[:, ::-1] if rev else counts).reshape(-1)

    def chunk_table(self, streams: Sequence[Tuple[str, int, bool]]):
        """(first tile of every chunk of the named streams, then the end
        [Q + 1] int32, chunks per stream): greedy, whole rows, at most
        ``CHUNK_TILES`` tiles a chunk, each stream starting a chunk."""
        starts, per_stream, t = [], [], 0
        for stream in streams:
            q0, fill = len(starts), CHUNK_TILES
            for n in self._rows(*stream):
                if n == 0:
                    continue
                if n > CHUNK_TILES:  # never: a row holds at most one block's tiles
                    raise ValueError(f"a row of {n} tiles is longer than a chunk")
                if fill + n > CHUNK_TILES:
                    starts.append(t)
                    fill = 0
                fill += n
                t += n
            per_stream.append(len(starts) - q0)
        return np.array(starts + [t], np.int32), tuple(per_stream)

    def args(self, ws: Sequence[torch.Tensor], streams: Sequence[Tuple[str, int, bool]]):
        """The engine's weight arguments for the named streams: (packed tiles,
        masks, chunks, chunks per stream), on the weights' device.  ``chunks``
        is int32 [S + 1 + Q + 1]: each stream's first chunk and then the count
        Q (the ring's ``q_base``), then ``chunk_table``'s first tiles."""
        dev = ws[0].device
        key = ("chunks", tuple(streams), str(dev))
        if key not in self._dev:
            table, per = self.chunk_table(streams)
            qbase = np.concatenate([[0], np.cumsum(per, dtype=np.int64)]).astype(np.int32)
            self._dev[key] = (torch.from_numpy(np.concatenate([qbase, table])).to(dev), per)
        chunks, per = self._dev[key]
        return self.pack(ws, streams), self.masks(dev), chunks, per

    def masks(self, device) -> torch.Tensor:
        """int32 [sum of the layers' fwd_blocks(D_l)*A*KS_l, then of their
        dm_blocks(C1_l)*A*DS_l]: the forward block masks of every layer, then
        the dm block masks of every layer (the bits of a uint32 each)."""
        key = ("masks", str(device))
        if key not in self._dev:
            n = len(self.widths)
            flat = np.concatenate([self.block_masks[(kind, i)].reshape(-1)
                                   for kind in ("fwd", "dm") for i in range(n)])
            self._dev[key] = torch.from_numpy(flat.view(np.int32).copy()).to(device)
        return self._dev[key]

    def pack(self, ws: Sequence[torch.Tensor], streams: Sequence[Tuple[str, int, bool]]):
        """The listed tiles of the weights ``ws`` (per layer [A*C1, D]) for the
        named streams, [tiles * 128] in the weights' dtype: one gather."""
        dev = ws[0].device
        key = ("index", tuple(streams), str(dev))
        if key not in self._dev:
            idx = self.index(streams)
            total = sum(self.a * c1 * d for c1, d in self.widths)
            self._dev[key] = torch.from_numpy(np.where(idx >= 0, idx, total)).to(dev)
        flat = torch.cat([w.reshape(-1) for w in ws] + [ws[0].new_zeros(1)])
        return flat[self._dev[key]]

    def unpack(self, packed: torch.Tensor, kind: str, layer: int):
        """One stream's tiles scattered back into W' [A*C1, D], zero
        elsewhere: the inverse of ``pack`` for a check."""
        c1, d = self.widths[layer]
        t = self._streams[(kind, layer, False)].reshape(-1)
        out = packed.new_zeros((self.a * c1 * d + 1,))
        out[torch.from_numpy(np.where(t >= 0, t, self.a * c1 * d))] = packed
        return out[:-1].view(self.a * c1, d)
