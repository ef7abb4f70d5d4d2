"""PyTorch port, the launch plans of two small kernels, on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``); what
their wrappers decide before a launch is plain Python and is tested here:

- the weight-gradient reduction (``kernels.fused_message.reduce_plan``):
  the column kernel, four columns a thread (16-byte loads), where NW is a
  multiple of 4, both bases are 16-byte aligned and NW / 4 columns give
  every SM a block; else strips of 32 columns staged through shared memory
  (any NW, any alignment); rows in batches or stages;
- the halo all-gather #15 (``kernels.halo_ring.ring_plan``): the widest
  word that divides a chunk's bytes and both bases (the tail path for odd
  H and F), one word of the exports a thread, at any P including 1;
- the reduction's function: the in-order fold (``acc += partials[b]``,
  b = 0..n-1, in fp32), which the kernel computes bit for bit, against the
  plain version (``torch.sum``) within 1e-6 * max(1, max|ref|): fp32 sums of
  the same rows in another order;
- the all-gather's function through the kernel's own flat addressing
  (``pools[r*P*chunk + i] = exports[i]``) against the plain version.
"""

import numpy as np
import pytest
import torch

from scalable_e3_gnn_torch.kernels import fused_message as fm
from scalable_e3_gnn_torch.kernels import halo_ring as hr

H100_SMS = 132
ALIGNED = (1 << 20, 1 << 24)


S = dict(cols=False, threads=fm.STRIP_THREADS, rows=fm.STRIP_ROWS)  # the strip kernel
C4 = dict(cols=True, threads=fm.COL_THREADS, rows=fm.COL_ROWS)  # 16-byte column loads


@pytest.mark.parametrize("nblocks,nw,ptrs,want", [
    # config 3's #2 partials: 9280 / 4 columns would leave SMs without a
    # block, so strips of 32 columns, the 132 rows in one stage
    (132, 9280, ALIGNED, dict(S, grid=290, batches=1)),
    (264, 9280, ALIGNED, dict(S, grid=290, batches=2)),
    # #12's and #14's partials at 250k: columns, 16-byte loads
    (22, 263412, ALIGNED, dict(C4, grid=1029, batches=2)),
    (128, 263412, ALIGNED, dict(C4, grid=1029, batches=8)),
    # NW not a multiple of 4: strips, the last one part full
    (22, 263413, ALIGNED, dict(S, grid=8232, batches=1)),
    (5, 1001, ALIGNED, dict(S, grid=32, batches=1)),
    (33, 3, ALIGNED, dict(S, grid=1, batches=1)),
    # a base off 16 bytes (partials, then out)
    (22, 263412, (ALIGNED[0] + 4, ALIGNED[1]), dict(S, grid=8232, batches=1)),
    (22, 263412, (ALIGNED[0], ALIGNED[1] + 8), dict(S, grid=8232, batches=1)),
    # one row, and none
    (1, 263412, ALIGNED, dict(C4, grid=1029, batches=1)),
    (1, 9280, ALIGNED, dict(S, grid=290, batches=1)),
    (0, 9280, ALIGNED, dict(S, grid=290, batches=0)),
    # either side of one block per SM at four columns a thread
    (64, 4 * 64 * H100_SMS, ALIGNED, dict(C4, grid=H100_SMS, batches=4)),
    (64, 4 * 64 * H100_SMS - 4, ALIGNED, dict(S, grid=1056, batches=1)),
])
def test_reduce_plan(nblocks, nw, ptrs, want):
    plan = fm.reduce_plan(nblocks, nw, ptrs, H100_SMS)
    assert plan == want
    # every column has a thread, and no block is wholly past the end
    per_block = 4 * plan["threads"] if plan["cols"] else fm.STRIP_COLS
    assert plan["grid"] * per_block >= nw > (plan["grid"] - 1) * per_block


def _fold(x):
    """The kernel's function: each column summed in row order in fp32, from 0."""
    acc = torch.zeros(x.shape[1], dtype=torch.float32)
    for row in x:
        acc += row
    return acc


@pytest.mark.parametrize("nblocks,nw,seed", [(132, 9280, 0), (22, 2634, 1), (128, 2634, 2),
                                             (7, 1001, 3), (1, 263, 4)])
def test_in_order_fold_against_plain_reduce(nblocks, nw, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((nblocks, nw))
                         .astype(np.float32))
    ref = fm.tab_bwd_reduce_plain(x)
    got = _fold(x)
    assert float((got - ref).abs().max()) <= 1e-6 * max(1.0, float(ref.abs().max()))
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(fm.tab_bwd_reduce(x), ref)
    if nblocks == 1:
        assert torch.equal(got, x[0])


@pytest.mark.parametrize("p,h,f,elem,ptrs,want", [
    # config 3's P=4 shape in bf16 and fp32: 16-byte words
    (4, 3090, 80, 2, ALIGNED, dict(vec_bytes=16, chunk=30900, grid=483)),
    (4, 3090, 80, 4, ALIGNED, dict(vec_bytes=16, chunk=61800, grid=966)),
    # odd H and F: the element (bf16) and word (fp32) tail paths
    (2, 37, 13, 2, ALIGNED, dict(vec_bytes=2, chunk=481, grid=4)),
    (8, 61, 7, 4, ALIGNED, dict(vec_bytes=4, chunk=427, grid=14)),
    (4, 129, 80, 2, ALIGNED, dict(vec_bytes=16, chunk=1290, grid=21)),
    (3, 37, 6, 2, ALIGNED, dict(vec_bytes=4, chunk=111, grid=2)),
    # P = 1: one pool, the exports copied
    (1, 37, 13, 4, ALIGNED, dict(vec_bytes=4, chunk=481, grid=2)),
    (1, 3090, 80, 2, ALIGNED, dict(vec_bytes=16, chunk=30900, grid=121)),
    # a base only 8-byte aligned
    (4, 3090, 80, 2, (ALIGNED[0] + 8, ALIGNED[1]), dict(vec_bytes=8, chunk=61800, grid=966)),
])
def test_ring_plan(p, h, f, elem, ptrs, want):
    plan = hr.ring_plan(p, h * f * elem, ptrs)
    assert plan == dict(threads=hr.THREADS, **want)
    assert plan["grid"] * plan["threads"] >= p * plan["chunk"]


def test_ring_plan_without_a_word():
    with pytest.raises(ValueError):
        hr.ring_plan(2, 3, ALIGNED)


@pytest.mark.parametrize("p,h,f", [(1, 37, 13), (2, 37, 13), (4, 129, 80), (8, 61, 7)])
def test_ring_flat_addressing_is_the_all_gather(p, h, f):
    """The kernel's addressing, word by word: flat index i of the exports
    goes to pools[r*P*chunk + i] for every r."""
    x = torch.from_numpy(np.random.default_rng(p * h).standard_normal((p, h, f))
                         .astype(np.float32))
    n = x.numel()
    flat = x.reshape(-1)
    pools = torch.empty(p * n)
    for r in range(p):
        pools[r * n + torch.arange(n)] = flat
    assert torch.equal(pools.view(p, p, h, f), hr.ring_all_gather_plain(x))
    assert torch.equal(hr.ring_all_gather_fwd(x), hr.ring_all_gather_plain(x))
