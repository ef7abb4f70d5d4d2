"""PyTorch port, ``data/native_loader.py``: the port's ctypes wrapper over
``native/loader.cpp`` against the JAX package's (``tests/test_native_loader.py``'s
cases), every function bit for bit on the same numpy inputs, and the port's
``partition_graph_dense`` with and without the native library, bit for bit,
and against JAX's at P = 1, 2, 4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalable_e3_gnn_tpu.data import native_loader as jnl
from scalable_e3_gnn_tpu.graph.morton import morton_encode_points
from scalable_e3_gnn_tpu.parallel.partition import partition_graph_dense as j_partition
from scalable_e3_gnn_torch.data import native_loader as nl
from scalable_e3_gnn_torch.parallel import partition as tpart

LO, HI = (0.0,) * 3, (1.0,) * 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the suite runs several workers on the
    same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cloud():
    return np.random.default_rng(0).random((50_000, 3)).astype(np.float32)


@pytest.fixture
def numpy_only(monkeypatch):
    """The port's module as if the library could not be built."""
    monkeypatch.setattr(nl, "_get", lambda: None)


def test_native_builds():
    assert nl.available(), "g++ build of native/loader.cpp failed"
    assert nl._lib_path().parent == nl.BUILD  # the port's own build directory


def test_encode_matches_jnp(cloud):
    pts_s, codes_s, order = nl.morton_encode_sort(cloud, LO, HI)
    ref = np.asarray(morton_encode_points(jnp.asarray(cloud), LO, HI)).astype(np.uint32)
    np.testing.assert_array_equal(codes_s, ref[order])
    assert (np.diff(codes_s.astype(np.int64)) >= 0).all()
    np.testing.assert_array_equal(pts_s, cloud[order])
    assert np.unique(order).size == cloud.shape[0]


def test_sort_stability(cloud):
    """Equal codes keep their input order."""
    pts = np.repeat(cloud[:1000], 4, axis=0)
    _, _, order = nl.morton_encode_sort(pts, LO, HI)
    want = np.argsort(nl._np_encode(pts, LO, HI), kind="stable").astype(np.int32)
    np.testing.assert_array_equal(order, want)


def test_gather_rows(cloud):
    feats = np.random.default_rng(1).standard_normal((cloud.shape[0], 7)).astype(np.float32)
    order = np.random.default_rng(2).permutation(cloud.shape[0]).astype(np.int32)
    np.testing.assert_array_equal(nl.gather_rows(feats, order), feats[order])


def test_load_points_bin(tmp_path):
    pts = np.random.default_rng(3).random((100, 3)).astype(np.float32)
    pts.tofile(tmp_path / "pts.bin")
    np.testing.assert_array_equal(np.asarray(nl.load_points_bin(str(tmp_path / "pts.bin"))), pts)


def test_rev_table_matches_numpy():
    """The counting-scatter table against a numpy reference: the counts, each
    row's slots, and the sentinel past each row's count."""
    rng = np.random.default_rng(7)
    slots, targets = 20000, 700
    tgt = rng.integers(0, targets + 5, slots).astype(np.int32)  # some out of range
    mask = rng.random(slots) < 0.8
    counts = nl.rev_counts(tgt, mask, targets)
    np.testing.assert_array_equal(counts, np.bincount(tgt[mask & (tgt < targets)],
                                                      minlength=targets))
    q = int(counts.max()) + 2
    rev = nl.rev_table(tgt, mask, targets, sentinel=slots, q=q)
    assert rev.shape == (targets, q)
    for t in range(0, targets, 37):
        row = rev[t]
        want = np.nonzero((tgt == t) & mask)[0]
        np.testing.assert_array_equal(np.sort(row[row < slots]), want)
        assert (row[len(want):] == slots).all()


def test_rev_table_multi_matches_per_partition():
    """The batched table (+1 encoding, 0 = empty) holds each row's slots in
    slot order, and the same slots as the per-partition table."""
    rng = np.random.default_rng(7)
    parts, rows, k, nt = 4, 200, 8, 210
    tgt = rng.integers(0, nt + 20, (parts, rows * k)).astype(np.int32)
    mask = (rng.random((parts, rows * k)) < 0.9).astype(np.uint8)
    q = max(int(nl.rev_counts(tgt[p], mask[p], nt).max()) for p in range(parts))
    multi = nl.rev_table_multi(tgt, mask, nt, q=q)
    assert multi.shape == (parts, nt, q)
    for p in range(parts):
        single = nl.rev_table(tgt[p], mask[p], nt, rows * k, q=q)
        for row in range(nt):
            got = [v - 1 for v in multi[p, row] if v > 0]
            assert got == sorted(got)
            assert got == sorted(v for v in single[row] if v < rows * k), (p, row)


def _inputs():
    rng = np.random.default_rng(11)
    n, k, parts, slots, nt = 4000, 8, 4, 3000, 900
    pts = rng.random((n, 3)).astype(np.float32)
    feats = rng.standard_normal((n, 6)).astype(np.float32)
    order = rng.permutation(n).astype(np.int32)
    senders = ((np.arange(n)[:, None] + rng.integers(-60, 61, (n, k))) % n).astype(np.int32)
    mask = rng.random((n, k)) < 0.85
    tgt = rng.integers(0, nt + 9, (parts, slots)).astype(np.int32)
    tmask = rng.random((parts, slots)) < 0.9
    return dict(pts=pts, feats=feats, order=order, senders=senders, mask=mask, tgt=tgt,
                tmask=tmask, nt=nt)


_CALLS = {
    "morton_encode_sort": lambda m, d: m.morton_encode_sort(d["pts"], LO, HI),
    "gather_rows": lambda m, d: m.gather_rows(d["feats"], d["order"]),
    "sender_pass": lambda m, d: m.sender_pass(d["senders"], d["mask"], 1000, 4),
    "take_i32": lambda m, d: m.take_i32(d["order"], d["senders"], d["mask"]),
    "rev_counts": lambda m, d: m.rev_counts(d["tgt"][1], d["tmask"][1], d["nt"]),
    "rev_table": lambda m, d: m.rev_table(d["tgt"][2], d["tmask"][2], d["nt"], sentinel=-1),
    "rev_table_multi": lambda m, d: m.rev_table_multi(d["tgt"], d["tmask"], d["nt"], q=12),
}


def _flat(x):
    return [np.asarray(a) for a in x] if isinstance(x, tuple) else [np.asarray(x)]


@pytest.mark.parametrize("fn", sorted(_CALLS))
def test_function_matches_jax(fn):
    """Each function bit for bit the JAX package's on the same inputs."""
    assert jnl.available(), "the JAX package's native library did not build"
    d = _inputs()
    got, want = _flat(_CALLS[fn](nl, d)), _flat(_CALLS[fn](jnl, d))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fn", ["morton_encode_sort", "gather_rows"])
def test_numpy_fallback_matches_native(fn, numpy_only):
    """Without the library the two numpy fallbacks give the native arrays."""
    d = _inputs()
    for a, b in zip(_flat(_CALLS[fn](nl, d)), _flat(_CALLS[fn](jnl, d)), strict=True):
        np.testing.assert_array_equal(a, b)


def test_without_library_the_partition_helpers_decline(numpy_only):
    d = _inputs()
    for fn in ("sender_pass", "take_i32", "rev_counts", "rev_table", "rev_table_multi"):
        assert _CALLS[fn](nl, d) is None, fn
    assert not nl.available()


def _graph():
    rng = np.random.default_rng(3)
    n, k = 512, 8
    senders = ((np.arange(n)[:, None] + rng.integers(-20, 21, size=(n, k))) % n).astype(np.int32)
    mask = rng.random((n, k)) < 0.9
    feats = rng.standard_normal((n, 4)).astype(np.float32)
    pos = rng.random((n, 3)).astype(np.float32)
    return pos, feats, senders, mask


@pytest.mark.parametrize("num_parts", [1, 2, 4])
def test_partition_native_and_numpy_match_jax(num_parts, monkeypatch):
    """The port's partitioner gives the same arrays, bit for bit, with and
    without the native library, and both are JAX's."""
    args = _graph()
    with_native = tpart.partition_graph_dense(*args, num_parts=num_parts)
    monkeypatch.setattr(nl, "_get", lambda: None)
    without = tpart.partition_graph_dense(*args, num_parts=num_parts)
    want = j_partition(*args, num_parts=num_parts)
    for name in want._fields:
        w = getattr(want, name)
        for got in (with_native, without):
            g = getattr(got, name)
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype and g.shape == w.shape, name
                np.testing.assert_array_equal(g, w, err_msg=name)
            else:
                assert g == w, name
