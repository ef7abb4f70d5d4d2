"""PyTorch port, ops: L1TensorProduct, Gate, O3Linear and O3TensorProductGate
against the JAX package, with the JAX weights carried over by params_from_jax:
outputs, and the gradients of <out, cotangent> with respect to the inputs and
parameters (PyTorch autograd against ``jax.grad``, compared key by key through
params_to_jax).  Tolerance: fp32 atol 2e-5 (same math, other summation order
in the GEMMs)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_e3_gnn_tpu.core.spherical import spherical_harmonics as jax_sh
from scalable_e3_gnn_tpu.models.segnn import O3TensorProductGate as JTPGate
from scalable_e3_gnn_tpu.ops.gate import Gate as JGate
from scalable_e3_gnn_tpu.ops.linear import O3Linear as JLinear
from scalable_e3_gnn_tpu.ops.tensor_product import L1TensorProduct as JTP
from scalable_e3_gnn_torch.models.segnn import O3TensorProductGate as TTPGate
from scalable_e3_gnn_torch.ops.gate import Gate as TGate
from scalable_e3_gnn_torch.ops.linear import O3Linear as TLinear
from scalable_e3_gnn_torch.ops.tensor_product import L1TensorProduct as TTP
from scalable_e3_gnn_torch.utils.params import params_from_jax, params_to_jax

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(n, dim, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    vec = rng.standard_normal((n, 3)).astype(np.float32)
    attr = np.array(jax.jit(jax_sh, static_argnums=0)(1, jnp.asarray(vec)))
    return x, attr


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("layouts", [("mul", "cm"), ("cm", "cm"), ("mul", "mul")])
@pytest.mark.parametrize("spec", [("16x0e+8x1o", "16x0e+8x0e+8x1o"),
                                  ("4x0e+2x0o+3x1o+2x1e", "3x0e+2x0o+2x1o+1x1e")])
def test_l1_tensor_product_matches_jax(layouts, spec):
    lin, lout = layouts
    jtp = JTP(spec[0], spec[1], layout_in1=lin, layout_out=lout)
    ttp = TTP(spec[0], spec[1], layout_in1=lin, layout_out=lout, device="cpu")
    params = jtp.init(jax.random.key(0))
    params_from_jax(ttp, _np_tree(params))
    assert ttp.instructions == jtp.instructions
    x, attr = _inputs(50, jtp.in1_dim, 1)
    ref = np.asarray(jax.jit(jtp.__call__)(params, jnp.asarray(x), jnp.asarray(attr)))
    got = ttp(torch.from_numpy(x), torch.from_numpy(attr)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_l1_tensor_product_leading_dims_and_path_norm():
    jtp = JTP("8x0e+4x1o", "4x0e+4x1o", path_normalization="none", layout_in1="cm")
    ttp = TTP("8x0e+4x1o", "4x0e+4x1o", path_normalization="none", layout_in1="cm",
              device="cpu")
    params = jtp.init(jax.random.key(3))
    params_from_jax(ttp, _np_tree(params))
    x, attr = _inputs(24, jtp.in1_dim, 2)
    x, attr = x.reshape(4, 6, -1), attr.reshape(4, 6, -1)
    ref = np.asarray(jax.jit(jtp.__call__)(params, jnp.asarray(x), jnp.asarray(attr)))
    got = ttp(torch.from_numpy(x), torch.from_numpy(attr)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("layout", ["mul", "cm"])
def test_gate_matches_jax(layout):
    jg = JGate("8x0e", "4x1o+2x1e", layout=layout)
    tg = TGate("8x0e", "4x1o+2x1e", layout=layout)
    x = np.random.default_rng(4).standard_normal((30, jg.irreps_in.dim)).astype(np.float32)
    ref = np.asarray(jax.jit(jg.__call__)(jnp.asarray(x)))
    got = tg(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("layouts", [("cm", "mul"), ("mul", "mul"), ("cm", "cm")])
def test_o3_linear_matches_jax(layouts):
    jl = JLinear("16x0e+8x1o", "2x0e+1x1o", layout_in=layouts[0], layout_out=layouts[1])
    tl = TLinear("16x0e+8x1o", "2x0e+1x1o", layout_in=layouts[0], layout_out=layouts[1],
                 device="cpu")
    params = jl.init(jax.random.key(5))
    params["b_0e"] = jnp.asarray([0.5, -1.0])
    params_from_jax(tl, _np_tree(params))
    x = np.random.default_rng(6).standard_normal((40, 40)).astype(np.float32)
    ref = np.asarray(jax.jit(jl.__call__)(params, jnp.asarray(x)))
    got = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("gated", [True, False])
def test_tp_gate_matches_jax(gated):
    attr_irreps = "1x0e+1x1o"
    j = JTPGate("16x0e+8x1o+16x0e+8x1o+1x0e", attr_irreps, "16x0e+8x1o", gated=gated,
                layout_in="cm", layout_out="cm")
    t = TTPGate("16x0e+8x1o+16x0e+8x1o+1x0e", attr_irreps, "16x0e+8x1o", gated=gated,
                layout_in="cm", layout_out="cm", device="cpu")
    params = j.init(jax.random.key(7))
    params_from_jax(t, _np_tree(params))
    x, attr = _inputs(60, 81, 8)
    ref = np.asarray(jax.jit(j.__call__)(params, jnp.asarray(x), jnp.asarray(attr)))
    got = t(torch.from_numpy(x), torch.from_numpy(attr)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_params_from_jax_rejects_mismatch():
    t = TTP("4x0e+2x1o", "4x0e+2x1o", device="cpu")
    good = {k: np.zeros(s, np.float32) for k, s in t.param_shapes().items()}
    with pytest.raises(KeyError):
        params_from_jax(t, {**good, "w_extra": np.zeros((1, 1))})
    bad = dict(good, w_l0e=np.zeros((1, 1), np.float32))
    with pytest.raises(ValueError):
        params_from_jax(t, bad)


def _assert_trees_close(got, want, atol=ATOL):
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], dict):
            _assert_trees_close(got[key], want[key], atol)
        else:
            np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=atol, err_msg=key)


def _grads_match(jmod, params, tmod, inputs, out_dim, seed):
    """d<out, c>/d(inputs, params) of both packages, for a random cotangent c."""
    ct = np.random.default_rng(seed).standard_normal(
        (inputs[0].shape[0], out_dim)).astype(np.float32)

    def jloss(p, x, *rest):
        return jnp.sum(jmod(p, x, *rest) * ct) if params is not None else \
            jnp.sum(jmod(x, *rest) * ct)

    argnums = (0, 1) if params is not None else (1,)
    jg = jax.jit(jax.grad(jloss, argnums=argnums))(params, *map(jnp.asarray, inputs))
    x = torch.from_numpy(inputs[0].copy()).requires_grad_(True)
    rest = [torch.from_numpy(r.copy()) for r in inputs[1:]]
    tmod.zero_grad()
    torch.sum(tmod(x, *rest) * torch.from_numpy(ct)).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg[-1]), atol=ATOL)
    assert np.abs(np.asarray(jg[-1])).max() > 1e-2
    if params is not None:
        _assert_trees_close(params_to_jax(tmod, grad=True), _np_tree(jg[0]))


@pytest.mark.parametrize("layouts", [("mul", "cm"), ("cm", "cm")])
def test_l1_tensor_product_gradients_match_jax(layouts):
    lin, lout = layouts
    jtp = JTP("16x0e+8x1o", "16x0e+8x0e+8x1o", layout_in1=lin, layout_out=lout)
    ttp = TTP("16x0e+8x1o", "16x0e+8x0e+8x1o", layout_in1=lin, layout_out=lout, device="cpu")
    params = jtp.init(jax.random.key(10))
    params_from_jax(ttp, _np_tree(params))
    x, attr = _inputs(50, jtp.in1_dim, 11)
    _grads_match(jtp.__call__, params, ttp, [x, attr], jtp.out_dim, 12)


@pytest.mark.parametrize("layout", ["mul", "cm"])
def test_gate_gradients_match_jax(layout):
    jg = JGate("8x0e", "4x1o+2x1e", layout=layout)
    tg = TGate("8x0e", "4x1o+2x1e", layout=layout)
    x = np.random.default_rng(13).standard_normal((30, jg.irreps_in.dim)).astype(np.float32)
    _grads_match(jg.__call__, None, tg, [x], jg.irreps_out.dim, 14)


@pytest.mark.parametrize("layouts", [("cm", "mul"), ("mul", "mul")])
def test_o3_linear_gradients_match_jax(layouts):
    jl = JLinear("16x0e+8x1o", "2x0e+1x1o", layout_in=layouts[0], layout_out=layouts[1])
    tl = TLinear("16x0e+8x1o", "2x0e+1x1o", layout_in=layouts[0], layout_out=layouts[1],
                 device="cpu")
    params = jl.init(jax.random.key(15))
    params["b_0e"] = jnp.asarray([0.5, -1.0])
    params_from_jax(tl, _np_tree(params))
    x = np.random.default_rng(16).standard_normal((40, 40)).astype(np.float32)
    _grads_match(jl.__call__, params, tl, [x], 5, 17)


@pytest.mark.parametrize("gated", [True, False])
def test_tp_gate_gradients_match_jax(gated):
    attr_irreps = "1x0e+1x1o"
    j = JTPGate("16x0e+8x1o+16x0e+8x1o+1x0e", attr_irreps, "16x0e+8x1o", gated=gated,
                layout_in="cm", layout_out="cm")
    t = TTPGate("16x0e+8x1o+16x0e+8x1o+1x0e", attr_irreps, "16x0e+8x1o", gated=gated,
                layout_in="cm", layout_out="cm", device="cpu")
    params = j.init(jax.random.key(18))
    params_from_jax(t, _np_tree(params))
    x, attr = _inputs(60, 81, 19)
    _grads_match(j.__call__, params, t, [x, attr], 40, 20)


def test_params_to_jax_round_trips():
    t = TTPGate("4x0e+2x1o", "1x0e+1x1o", "4x0e+2x1o", device="cpu",
                generator=torch.Generator().manual_seed(0))
    tree = params_to_jax(t)
    assert set(tree) == set(t.tp.param_shapes())
    u = TTPGate("4x0e+2x1o", "1x0e+1x1o", "4x0e+2x1o", device="cpu")
    params_from_jax(u, tree)
    _assert_trees_close(params_to_jax(u), tree, atol=0)
    assert all(not v.any() for v in params_to_jax(u, grad=True).values())
