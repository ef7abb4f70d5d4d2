"""Wigner 3j / Clebsch-Gordan coefficients in the real O(3) basis.

A copy of ``scalable_e3_gnn_tpu/core/wigner.py`` (numpy, float64), kept here
so the PyTorch package imports nothing of the JAX package.  The tensors are
constants of the tensor products and the spherical harmonics, built when a
module is constructed.  The lmax=1 entries reproduce the L1 tensor product's
constants:

    wigner_3j(1,1,0) = I/sqrt(3)        -> CG110 = 1/sqrt(3)
    wigner_3j(0,1,1) = I/sqrt(3)        -> CG011 = 1/sqrt(3)
    wigner_3j(1,1,1) = eps/sqrt(6)      -> CG111 = 1/sqrt(6)

All tensors have unit Frobenius norm.  Method: su(2) Clebsch-Gordan by the
Racah closed form, then the unitary change of basis from complex to real
spherical harmonics with an i**l phase that makes the result real.
"""

from __future__ import annotations

import functools
from fractions import Fraction
from math import factorial, sqrt

import numpy as np

__all__ = ["wigner_3j", "su2_clebsch_gordan", "change_basis_real_to_complex"]


def _tri_coefficient(j1: int, j2: int, j3: int) -> Fraction:
    """Triangle coefficient Δ(j1,j2,j3) as an exact fraction."""
    return Fraction(
        factorial(j1 + j2 - j3) * factorial(j1 - j2 + j3) * factorial(-j1 + j2 + j3),
        factorial(j1 + j2 + j3 + 1),
    )


def _cg_coefficient(j1: int, m1: int, j2: int, m2: int, j3: int, m3: int) -> float:
    """⟨j1 m1; j2 m2 | j3 m3⟩ via the Racah formula (integer j only)."""
    if m3 != m1 + m2:
        return 0.0
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0
    if abs(m1) > j1 or abs(m2) > j2 or abs(m3) > j3:
        return 0.0

    pref = Fraction(2 * j3 + 1) * _tri_coefficient(j1, j2, j3)
    pref *= (
        factorial(j3 + m3)
        * factorial(j3 - m3)
        * factorial(j1 - m1)
        * factorial(j1 + m1)
        * factorial(j2 - m2)
        * factorial(j2 + m2)
    )

    total = Fraction(0)
    kmin = max(0, j2 - j3 - m1, j1 - j3 + m2)
    kmax = min(j1 + j2 - j3, j1 - m1, j2 + m2)
    for k in range(kmin, kmax + 1):
        denom = (
            factorial(k)
            * factorial(j1 + j2 - j3 - k)
            * factorial(j1 - m1 - k)
            * factorial(j2 + m2 - k)
            * factorial(j3 - j2 + m1 + k)
            * factorial(j3 - j1 - m2 + k)
        )
        total += Fraction((-1) ** k, denom)

    sign = 1.0 if total >= 0 else -1.0
    return sign * sqrt(float(pref) * float(total) ** 2) if total != 0 else 0.0


@functools.lru_cache(maxsize=None)
def su2_clebsch_gordan(j1: int, j2: int, j3: int) -> np.ndarray:
    """CG tensor C[m1, m2, m3] in the complex |j m⟩ basis, m = -j..j."""
    C = np.zeros((2 * j1 + 1, 2 * j2 + 1, 2 * j3 + 1))
    for i1, m1 in enumerate(range(-j1, j1 + 1)):
        for i2, m2 in enumerate(range(-j2, j2 + 1)):
            for i3, m3 in enumerate(range(-j3, j3 + 1)):
                C[i1, i2, i3] = _cg_coefficient(j1, m1, j2, m2, j3, m3)
    return C


@functools.lru_cache(maxsize=None)
def change_basis_real_to_complex(l: int) -> np.ndarray:
    """Unitary Q with  Y_complex = Q @ y_real  (rows m=-l..l, cols real index).

    The real basis is fixed so that the l=1 components transform as the
    coordinates (y, z, x), e3nn's order.
    """
    q = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.complex128)
    for m in range(-l, 0):
        q[l + m, l + abs(m)] = 1 / sqrt(2)
        q[l + m, l - abs(m)] = -1j / sqrt(2)
    q[l, l] = 1.0
    for m in range(1, l + 1):
        q[l + m, l + abs(m)] = (-1) ** m / sqrt(2)
        q[l + m, l - abs(m)] = 1j * (-1) ** m / sqrt(2)
    # global phase making the real-basis 3j tensors purely real
    return (-1j) ** l * q


@functools.lru_cache(maxsize=None)
def wigner_3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis equivariant 3-tensor C[a, b, c], unit Frobenius norm.

    Contracting the first two indices with real-basis features of irreps
    (l1, l2) gives irrep l3 features:  out_c = Σ_ab C[a,b,c] x_a y_b.
    The zero tensor if the triangle inequality fails.
    """
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    C = su2_clebsch_gordan(l1, l2, l3).astype(np.complex128)
    Q1 = change_basis_real_to_complex(l1)
    Q2 = change_basis_real_to_complex(l2)
    Q3 = change_basis_real_to_complex(l3)
    # complex CG contracts complex coefficients; each leg to the real basis
    C = np.einsum("ijk,il,jm,kn->lmn", C, np.conj(Q1), np.conj(Q2), Q3)
    assert np.abs(C.imag).max() < 1e-12, f"w3j({l1},{l2},{l3}) not real"
    C = C.real
    n = np.linalg.norm(C)
    return C / n if n > 0 else C
