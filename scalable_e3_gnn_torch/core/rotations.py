"""Wigner-D rotation matrices in the package's real irrep basis.

A copy of ``scalable_e3_gnn_tpu/core/rotations.py`` (numpy, float64), kept
here so the port imports nothing of the JAX package.  Given a 3x3 orthogonal
matrix R (det +-1), ``wigner_D_from_matrix`` gives the (2l+1)x(2l+1) D_l(R)
with ``Y_l(R v) = D_l(R) Y_l(v)`` for the package's spherical harmonics, and
``irrep_rotation`` the O(3) action ``det(R)^{(1-p)/2} D_l(R)`` on an (l, p)
irrep.  D_1 is the coordinate rotation in (y, z, x) order; higher D_l are
solved by least squares from sh evaluations on random points.  The
equivariance tests use them.
"""

from __future__ import annotations

import numpy as np

__all__ = ["random_rotation", "wigner_D_from_matrix", "irrep_rotation"]

_PERM = np.array([1, 2, 0])  # (x,y,z) -> (y,z,x) component order


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    """Random proper rotation via QR."""
    A = rng.standard_normal((3, 3))
    Q, R = np.linalg.qr(A)
    Q = Q * np.sign(np.diag(R))
    if np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    return Q


def _sh_numpy(lmax: int, v: np.ndarray) -> np.ndarray:
    """float64 sh of unit vectors, mirroring ``core.spherical``."""
    from .spherical import _recursion_constants

    outs = [np.ones(v.shape[:-1] + (1,))]
    if lmax >= 1:
        y1 = np.sqrt(3.0) * v[..., _PERM]
        outs.append(y1)
        y_prev = y1
        for C, n in _recursion_constants(lmax):
            y_prev = n * np.einsum("...a,...b,abc->...c", y_prev, y1, C)
            outs.append(y_prev)
    return np.concatenate(outs, axis=-1)


def wigner_D_from_matrix(l: int, R: np.ndarray) -> np.ndarray:
    """D_l(R) for a proper rotation R (3x3, det +1)."""
    if l == 0:
        return np.ones((1, 1))
    if l == 1:
        return R[np.ix_(_PERM, _PERM)]
    rng = np.random.default_rng(12345)
    pts = rng.standard_normal((max(8 * (2 * l + 1), 64), 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    Y = _sh_numpy(l, pts)[..., l * l : (l + 1) * (l + 1)]
    YR = _sh_numpy(l, pts @ R.T)[..., l * l : (l + 1) * (l + 1)]
    D, *_ = np.linalg.lstsq(Y, YR, rcond=None)
    return D.T


def irrep_rotation(l: int, p: int, R: np.ndarray) -> np.ndarray:
    """O(3) action on an (l, p) irrep: R may include inversion (det -1),
    under which sh of order l pick up (-1)^l and the irrep its parity p."""
    det = np.linalg.det(R)
    D = wigner_D_from_matrix(l, R * np.sign(det))
    if det < 0:
        D = D * (p if p in (1, -1) else 1)
    return D
