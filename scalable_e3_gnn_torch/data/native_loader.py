"""ctypes bindings of the native host helpers in ``native/loader.cpp``.

Counterpart of ``scalable_e3_gnn_tpu/data/native_loader.py``: a threaded
Morton encode and radix sort of a point cloud (the bit layout of
``graph/morton.py``: 30-bit codes, 10 bits an axis, x highest), a threaded
row gather, a memory-mapped point file, and the dense partitioner's passes
(``parallel/partition.py``): the sender pass, the masked int32 gather and the
sender-transpose tables.

The library is compiled with ``g++`` at first use, into the package's
``_build/`` under a name that carries a hash of the source (so it is never
stale), and renamed into place when complete, so processes that build at the
same time never load a half-written file.  Without a compiler, or when the
build fails, ``available()`` is False and each function falls back as the
JAX module's does: to numpy, or to None where its caller keeps a numpy path
of its own.  Nothing is built or loaded when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["available", "morton_encode_sort", "gather_rows", "load_points_bin",
           "rev_counts", "rev_table", "rev_table_multi", "sender_pass", "take_i32"]

SOURCE = Path(__file__).resolve().parents[2] / "native" / "loader.cpp"
BUILD = Path(__file__).resolve().parents[1] / "_build"
BITS = 10

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i8p = ctypes.POINTER(ctypes.c_int8)
_f32p = ctypes.POINTER(ctypes.c_float)
_i64 = ctypes.c_int64
_SIGNATURES = {
    "e3_encode_sort_points": [_f32p, _i64, _f32p, _f32p, _f32p,
                              ctypes.POINTER(ctypes.c_uint32), _i32p],
    "e3_gather_rows_f32": [_f32p, _i32p, _i64, _i64, _f32p],
    "e3_rev_count": [_i32p, _u8p, _i64, _i64, _i32p],
    "e3_rev_fill": [_i32p, _u8p, _i64, _i64, ctypes.c_int32, ctypes.c_int32, _i32p],
    "e3_rev_scatter1": [_i32p, _u8p, _i64, _i64, _i64, ctypes.c_int32, _i32p],
    "e3_sender_pass": [_i32p, _u8p, _i64, _i64, _i64, ctypes.c_int32, _i8p, _u8p, _u8p],
    "e3_take_i32": [_i32p, _i32p, _u8p, _i64, _i32p],
}


def _lib_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD / f"libe3loader-{digest}.so"


def _build() -> Optional[ctypes.CDLL]:
    """Compile ``native/loader.cpp`` (when not built yet) and load it; None
    when the source, the compiler or the build is missing."""
    if not SOURCE.exists():
        return None
    path = _lib_path()
    if not path.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE),
               "-lpthread"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = None
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is None and not _build_failed:
            _lib = _build()
            _build_failed = _lib is None
        return _lib


def available() -> bool:
    """True if the native library is (or can be) built and loaded."""
    return _get() is not None


def _ptr(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def _as_u8(mask: np.ndarray) -> np.ndarray:
    """A contiguous uint8 view of a mask: a free reinterpretation of a
    C-contiguous bool array (``ascontiguousarray(mask, np.uint8)`` would copy
    it), a copy otherwise."""
    if mask.dtype == np.bool_ and mask.flags.c_contiguous:
        return mask.view(np.uint8)
    return np.ascontiguousarray(mask, np.uint8)


def _mask_ptr(mask: Optional[np.ndarray]):
    return ctypes.cast(None, _u8p) if mask is None else _ptr(mask, _u8p)


def _np_encode(points: np.ndarray, lo, hi) -> np.ndarray:
    """The numpy Morton encode, ``graph/morton.py``'s codes."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    scale = (1 << BITS) / (hi - lo)
    q = np.clip(((points - lo) * scale).astype(np.int64), 0, (1 << BITS) - 1)

    def part(x):
        x = x & 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return ((part(q[:, 0]) << 2) | (part(q[:, 1]) << 1) | part(q[:, 2])).astype(np.uint32)


def morton_encode_sort(points: np.ndarray, lo, hi) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(points_sorted [N, 3] f32, codes_sorted [N] uint32, order [N] int32)``,
    ``points_sorted == points[order]``, the sort stable; threaded native path
    when available, numpy otherwise."""
    pts = np.ascontiguousarray(points, np.float32)
    lib = _get()
    if lib is None:
        codes = _np_encode(pts, lo, hi)
        order = np.argsort(codes, kind="stable").astype(np.int32)
        return pts[order], codes[order], order
    n = pts.shape[0]
    lo_a, hi_a = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    out_pts = np.empty_like(pts)
    out_codes = np.empty((n,), np.uint32)
    out_order = np.empty((n,), np.int32)
    lib.e3_encode_sort_points(_ptr(pts, _f32p), n, _ptr(lo_a, _f32p), _ptr(hi_a, _f32p),
                              _ptr(out_pts, _f32p),
                              _ptr(out_codes, ctypes.POINTER(ctypes.c_uint32)),
                              _ptr(out_order, _i32p))
    return out_pts, out_codes, out_order


def gather_rows(src: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Threaded ``src[order]`` of a [N, F] float32 array."""
    src = np.ascontiguousarray(src, np.float32)
    order = np.ascontiguousarray(order, np.int32)
    lib = _get()
    if lib is None:
        return src[order]
    out = np.empty((order.shape[0], src.shape[1]), np.float32)
    lib.e3_gather_rows_f32(_ptr(src, _f32p), _ptr(order, _i32p), order.shape[0], src.shape[1],
                           _ptr(out, _f32p))
    return out


def load_points_bin(path: str, dim: int = 3) -> np.ndarray:
    """Memory-map a raw float32 [N, dim] point file (no copy until touched)."""
    return np.memmap(path, dtype=np.float32, mode="r").reshape(-1, dim)


def rev_table_multi(tgt: np.ndarray, mask: Optional[np.ndarray], n_targets: int,
                    q: int) -> Optional[np.ndarray]:
    """``[P, n_targets, q]`` sender-transpose tables of P partitions in one
    call: per partition and target, the flat slot positions ``i`` (of the
    valid slots with ``tgt[p, i] == target``) as ``i + 1``, in slot order,
    0 = empty (``ops.gather_scatter.take_dense_rev``'s encoding).  ``tgt``,
    ``mask``: [P, S].  The table starts as zero pages; only the real entries
    are written.  None when the library is absent."""
    lib = _get()
    if lib is None:
        return None
    num_parts, slots = tgt.shape
    tgt = np.ascontiguousarray(tgt, np.int32)
    mk = None if mask is None else _as_u8(mask)
    rev = np.zeros((num_parts, n_targets, q), np.int32)
    lib.e3_rev_scatter1(_ptr(tgt, _i32p), _mask_ptr(mk), num_parts, slots, n_targets, q,
                        _ptr(rev, _i32p))
    return rev


def sender_pass(senders: np.ndarray, mask: np.ndarray, npp0: int, num_parts: int):
    """``(owner int8 [N, K], remote bool [N, K], row_remote bool [N])`` in one
    threaded pass: a valid slot's owner ``min(sender // npp0, P - 1)`` (-1 on
    masked slots), whether it is owned by another partition than its row,
    and whether its row has such a slot.  None when the library is absent or
    P > 127 (the owner is int8)."""
    lib = _get()
    if lib is None or num_parts > 127:
        return None
    n, k = senders.shape
    senders = np.ascontiguousarray(senders, np.int32)
    mk = _as_u8(mask)
    owner = np.empty((n, k), np.int8)
    remote = np.empty((n, k), np.uint8)
    row_remote = np.empty((n,), np.uint8)
    lib.e3_sender_pass(_ptr(senders, _i32p), _ptr(mk, _u8p), n, k, npp0, num_parts - 1,
                       _ptr(owner, _i8p), _ptr(remote, _u8p), _ptr(row_remote, _u8p))
    return owner, remote.view(bool), row_remote.view(bool)


def take_i32(table: np.ndarray, idx: np.ndarray, mask: np.ndarray) -> Optional[np.ndarray]:
    """Threaded masked int32 gather ``table[mask ? idx : 0]``; None when the
    library is absent."""
    lib = _get()
    if lib is None:
        return None
    table = np.ascontiguousarray(table, np.int32)
    shape = idx.shape
    idx = np.ascontiguousarray(idx, np.int32).reshape(-1)
    mk = _as_u8(mask).reshape(-1)
    out = np.empty(idx.shape, np.int32)
    lib.e3_take_i32(_ptr(table, _i32p), _ptr(idx, _i32p), _ptr(mk, _u8p), idx.shape[0],
                    _ptr(out, _i32p))
    return out.reshape(shape)


def rev_counts(tgt: np.ndarray, mask: Optional[np.ndarray],
               n_targets: int) -> Optional[np.ndarray]:
    """``[n_targets]`` int32: the valid slots of ``tgt`` [S] naming each
    target (slots out of ``[0, n_targets)`` skipped); None when the library
    is absent."""
    lib = _get()
    if lib is None:
        return None
    tgt = np.ascontiguousarray(tgt, np.int32)
    mk = None if mask is None else _as_u8(mask)
    counts = np.zeros((n_targets,), np.int32)
    lib.e3_rev_count(_ptr(tgt, _i32p), _mask_ptr(mk), tgt.shape[0], n_targets,
                     _ptr(counts, _i32p))
    return counts


def rev_table(tgt: np.ndarray, mask: Optional[np.ndarray], n_targets: int, sentinel: int,
              q: Optional[int] = None, out: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """``[n_targets, q]`` sender-transpose table of one block by a threaded
    counting scatter: per target, the flat slot positions naming it (order
    within a row unspecified), padded with ``sentinel``; ``q`` the largest
    count (at least 1) when None; written into ``out`` when given.  None when
    the library is absent."""
    lib = _get()
    if lib is None:
        return None
    tgt = np.ascontiguousarray(tgt, np.int32)
    mk = None if mask is None else _as_u8(mask)
    if q is None:
        counts = rev_counts(tgt, mk, n_targets)
        q = max(int(counts.max()) if n_targets else 0, 1)
    if out is not None:
        if out.shape != (n_targets, q) or out.dtype != np.int32 or not out.flags.c_contiguous:
            raise ValueError(f"out must be a C-contiguous int32 [{n_targets}, {q}] array")
        rev = out
    else:
        rev = np.empty((n_targets, q), np.int32)
    lib.e3_rev_fill(_ptr(tgt, _i32p), _mask_ptr(mk), tgt.shape[0], n_targets, q, sentinel,
                    _ptr(rev, _i32p))
    return rev
