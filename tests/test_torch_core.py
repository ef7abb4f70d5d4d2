"""PyTorch port, core: Irreps algebra and spherical harmonics vs the JAX package."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalable_e3_gnn_tpu.core import irreps as jir
from scalable_e3_gnn_tpu.core.spherical import spherical_harmonics as jax_sh
from scalable_e3_gnn_torch.core import irreps as tir
from scalable_e3_gnn_torch.core.spherical import spherical_harmonics as torch_sh

SPECS = ["8x0e+8x1o", "4x0e+2x0o+3x1o+2x1e", "32x0e+16x1o+32x0e+16x1o+1x0e",
         "1x1o+2x0e+1x1o", "2x0e+1x1o"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("spec", SPECS)
def test_irreps_matches_jax(spec):
    a, b = jir.Irreps(spec), tir.Irreps(spec)
    assert repr(a) == repr(b)
    assert (a.dim, a.num_irreps, a.lmax, a.ls) == (b.dim, b.num_irreps, b.lmax, b.ls)
    assert a.slices() == b.slices()
    assert repr(a.regroup()) == repr(b.regroup())
    assert repr(a.sort()) == repr(b.sort())
    assert a.is_blockwise() == b.is_blockwise()
    for ir in ("0e", "0o", "1o", "1e"):
        assert a.mul_for(ir) == b.mul_for(ir)
        assert a.regroup().contiguous_slice_for(ir) == b.regroup().contiguous_slice_for(ir)
    assert {repr(k): v for k, v in a.slices_by_irrep().items()} == {
        repr(k): v for k, v in b.slices_by_irrep().items()}


def test_irrep_order_and_products_match_jax():
    names = ["0e", "0o", "1o", "1e", "2e", "2o"]
    ja = sorted(jir.Irrep.parse(s) for s in reversed(names))
    ta = sorted(tir.Irrep.parse(s) for s in reversed(names))
    assert [repr(x) for x in ja] == [repr(x) for x in ta] == names
    for x in names:
        for y in names:
            assert ([repr(i) for i in jir.Irrep.parse(x) * jir.Irrep.parse(y)]
                    == [repr(i) for i in tir.Irrep.parse(x) * tir.Irrep.parse(y)])
    assert repr(tir.Irreps.spherical_harmonics(1)) == "1x0e+1x1o"


@pytest.mark.parametrize("lmax", [0, 1, 2, 3])
@pytest.mark.parametrize("normalization", ["component", "norm", "integral"])
def test_spherical_harmonics_match_jax(lmax, normalization):
    """fp32, atol 1e-6: the same elementwise ops (above l=1 the same 3j
    contractions, summed in another order)."""
    rng = np.random.default_rng(lmax)
    v = rng.standard_normal((64, 5, 3)).astype(np.float32)
    v[0, 0] = 0.0  # padding vector: embeds to [1, 0, 0, 0]
    ref = np.asarray(jax_sh(lmax, jnp.asarray(v), normalization=normalization))
    got = torch_sh(lmax, torch.from_numpy(v), normalization=normalization).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_spherical_harmonics_unnormalized_and_lmax2():
    """Unnormalized vectors: lmax=1 (the same elementwise ops) at atol 1e-6;
    lmax=2 (the recursion scales Y_l with |v|^l and contracts the 3j tensors
    in another order) at atol 1e-5 relative to the largest entry."""
    v = np.random.default_rng(3).standard_normal((16, 3)).astype(np.float32)
    for lmax in (1, 2):
        ref = np.asarray(jax_sh(lmax, jnp.asarray(v), normalize=False))
        got = torch_sh(lmax, torch.from_numpy(v), normalize=False).numpy()
        assert got.shape == (16, (lmax + 1) ** 2)
        atol = 1e-6 if lmax == 1 else 1e-5 * max(1.0, np.abs(ref).max())
        np.testing.assert_allclose(got, ref, atol=atol)


@pytest.mark.parametrize("lmax", [4, 5])
@pytest.mark.parametrize("normalization", ["component", "norm"])
def test_spherical_harmonics_lmax4_5_match_jax(lmax, normalization):
    """The attributes of ``lmax_attr`` 4 and 5 (the non-foldable message
    layers, 25 and 36 wide): fp32, atol 1e-6 * max(1, max|ref|), as for
    lmax <= 3 in units of the largest entry (the component normalization
    scales Y_5 up to 3.2, and each side is 1.4e-6 from a float64 evaluation
    there)."""
    rng = np.random.default_rng(10 + lmax)
    v = rng.standard_normal((64, 5, 3)).astype(np.float32)
    v[0, 0] = 0.0
    ref = np.asarray(jax_sh(lmax, jnp.asarray(v), normalization=normalization))
    got = torch_sh(lmax, torch.from_numpy(v), normalization=normalization).numpy()
    assert got.shape == (64, 5, (lmax + 1) ** 2)
    np.testing.assert_allclose(got, ref, atol=1e-6 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("l1", [0, 1, 2, 3, 4, 5])
def test_wigner_3j_l4_l5_triples_equal_jax(l1):
    """Every triple up to l = 5 with an l of 4 or 5 (the lmax_attr=5 tensor
    products reach (2, 4, 2); the lmax=5 spherical harmonics use (4, 1, 5)):
    bitwise equal to the JAX package's, as the l <= 3 triples are."""
    from scalable_e3_gnn_tpu.core.wigner import wigner_3j as j_w3j
    from scalable_e3_gnn_torch.core.wigner import wigner_3j as t_w3j

    met = 0
    for l2 in range(6):
        for l3 in range(6):
            if max(l1, l2, l3) < 4 or not abs(l1 - l2) <= l3 <= l1 + l2:
                continue
            np.testing.assert_array_equal(t_w3j(l1, l2, l3), j_w3j(l1, l2, l3))
            met += 1
    assert met > 0
