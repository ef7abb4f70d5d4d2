"""PyTorch port, ``run_pointcloud`` (configs 3-5) against the JAX runner;
here config ``cloud100k`` and the helpers, ``test_torch_entry_lmax2.py``
config ``cloud1m``, ``test_torch_entry_large.py`` the branch above 2M points.

- ``run_pointcloud`` from JAX's initial weights (carried by
  ``params_from_jax``) at 2,000 points, configs ``cloud100k`` (lmax=1) and
  ``cloud1m`` (lmax=2), in fp32 and in bf16: the same result keys and
  ``edges``; the 3-step loss curve and ``eval_mse`` within 1e-5 relative in
  fp32 (the same math summed in another order) and 3.3e-5 in bf16
  (ROADMAP.md section 3's limit for bf16 curves).  One exception: the
  lmax=2 bf16 curve after the first Adam step, and its ``eval_mse``, within
  3e-3, because they move by more than 3.3e-5 when only the port's own fp32
  sum order changes (``test_torch_entry_lmax2.py::
  test_bf16_curve_moves_with_the_sum_order``); its first loss, the forward
  from the same weights, is held to 3.3e-5.
- On the GPU the runner asks for the kernels at every cloud config; with
  that choice forced on the CPU (the kernels' plain versions), the fp32
  curves stay within 1e-5 of JAX's and the untabled kernel entries run.
  The JAX runner runs once per config and precision (``_jax_run``).
- ``params_from_jax`` loads the three cloud configs' models.
"""

import functools
import json
import tempfile

import numpy as np
import pytest
import torch

import jax

from scalable_e3_gnn_tpu.core.irreps import Irreps as JIrreps
from scalable_e3_gnn_tpu.models.segnn import SEGNN as JSEGNN
from scalable_e3_gnn_tpu.train import runners as jrunners
from scalable_e3_gnn_tpu.utils import config as jconfig
from scalable_e3_gnn_torch.kernels.fused_message_generic import FusedMessageGeneric
from scalable_e3_gnn_torch.models import segnn as tsegnn
from scalable_e3_gnn_torch.train import runners as trunners
from scalable_e3_gnn_torch.utils import config as tconfig
from scalable_e3_gnn_torch.utils.params import params_from_jax, params_to_jax

CLOUDS = ("cloud100k", "cloud1m", "cloud10m")
TOL_BF16 = 3.3e-5  # relative, per loss; the reasons above
TOL_BF16_LMAX2_STEPPED = 3e-3  # lmax=2 after the first update (the module docstring)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(cfg, **ladder):
    m = cfg.model
    return JSEGNN(JIrreps(m.input_irreps), JIrreps(m.hidden_irreps), JIrreps(m.output_irreps),
                  lmax_attr=m.lmax_attr, num_layers=m.num_layers, remat=m.remat, layout=m.layout,
                  **ladder)


def _jax_init(cfg, seed=0):
    """The JAX runner's initial weights for ``cfg`` (``jax.random.key(seed)``)."""
    return jax.tree.map(np.asarray, _jax_model(cfg).init(jax.random.key(seed)))


def _load_jax_weights(monkeypatch, params, seen=None):
    """The port runner's model gets ``params``; ``seen`` collects its ladder."""
    make = trunners._cloud_model

    def model(c, d, s, **ladder):
        if seen is not None:
            seen.append(ladder)
        return params_from_jax(make(c, d, s, **ladder), params)

    monkeypatch.setattr(trunners, "_cloud_model", model)


def _losses(path):
    with open(path) as f:
        return np.array([r["loss"] for r in map(json.loads, f) if "loss" in r])


def _configs(name, bf16):
    jcfg, tcfg = getattr(jconfig, f"{name}_config")(), getattr(tconfig, f"{name}_config")()
    jcfg.train.bf16 = tcfg.train.bf16 = bf16
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_run(name, bf16):
    """The JAX runner at 2,000 points, 3 steps: (result, losses); run once
    per config and precision, its compile cache off."""
    jcfg, _ = _configs(name, bf16)
    setup, jrunners._setup = jrunners._setup, lambda: None
    try:
        with tempfile.TemporaryDirectory() as d:
            log = f"{d}/jax.jsonl"
            want = jrunners.run_pointcloud(jcfg, points=2000, steps=3, log=log)
            return want, _losses(log)
    finally:
        jrunners._setup = setup


def check_run_pointcloud(name, bf16, tmp_path, monkeypatch):
    """``run_pointcloud`` against the JAX runner (the module docstring)."""
    jcfg, tcfg = _configs(name, bf16)
    _load_jax_weights(monkeypatch, _jax_init(jcfg))
    want, jl = _jax_run(name, bf16)
    tlog = str(tmp_path / "torch.jsonl")
    got = trunners.run_pointcloud(tcfg, points=2000, steps=3, log=tlog, device="cpu")
    assert list(got) == list(want) == ["final_loss", "steps", "edges", "eval_mse"]
    assert got["edges"] == want["edges"] and got["steps"] == 3
    tl = _losses(tlog)
    first = TOL_BF16 if bf16 else 1e-5
    rtol = (TOL_BF16_LMAX2_STEPPED if tcfg.model.lmax_attr == 2 else TOL_BF16) if bf16 else 1e-5
    np.testing.assert_allclose(tl[0], jl[0], rtol=first, atol=0)
    np.testing.assert_allclose(tl, jl, rtol=rtol, atol=0)
    assert jl[2] < jl[0]  # the loss moves
    np.testing.assert_allclose(got["eval_mse"], want["eval_mse"], rtol=rtol)
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=rtol)


def check_kernel_dispatch(name, tmp_path, monkeypatch):
    """The GPU's dispatch forced on the CPU: the kernels' plain versions,
    against the JAX runner's fp32 curve; the untabled entries run 4 times
    (4 layers) in each of the 3 steps and in the held-out forward."""
    jcfg, tcfg = _configs(name, False)
    _load_jax_weights(monkeypatch, _jax_init(jcfg))
    monkeypatch.setattr(trunners, "_use_kernels", lambda cfg, dev: True)
    calls = {"km": 0, "generic": 0}
    km = tsegnn.fused_message_aggregate_km

    def count_km(*a, **kw):
        calls["km"] += 1
        return km(*a, **kw)

    monkeypatch.setattr(tsegnn, "fused_message_aggregate_km", count_km)
    for meth in ("geo_call", "geo_call_sym"):
        orig = getattr(FusedMessageGeneric, meth)

        def counted(self, *a, _orig=orig, **kw):
            calls["generic"] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(FusedMessageGeneric, meth, counted)
    want, jl = _jax_run(name, False)
    tlog = str(tmp_path / "torch.jsonl")
    got = trunners.run_pointcloud(tcfg, points=2000, steps=3, log=tlog, device="cpu")
    np.testing.assert_allclose(_losses(tlog), jl, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got["eval_mse"], want["eval_mse"], rtol=1e-5)
    assert calls == ({"km": 16, "generic": 0} if tcfg.model.lmax_attr == 1
                     else {"km": 0, "generic": 16})


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_run_pointcloud_matches_jax(bf16, tmp_path, monkeypatch):
    check_run_pointcloud("cloud100k", bf16, tmp_path, monkeypatch)


def test_kernel_dispatch_on_the_cpu_matches_jax(tmp_path, monkeypatch):
    check_kernel_dispatch("cloud100k", tmp_path, monkeypatch)


@pytest.mark.parametrize("name", CLOUDS)
def test_runner_asks_for_the_kernels_on_the_gpu(name):
    cfg = getattr(tconfig, f"{name}_config")()
    assert cfg.model.layout in (None, "cm")
    assert trunners._use_kernels(cfg, torch.device("cuda"))
    assert not trunners._use_kernels(cfg, torch.device("cpu"))


@pytest.mark.parametrize("name", CLOUDS)
def test_params_from_jax_loads_cloud_models(name):
    cfg = getattr(tconfig, f"{name}_config")()
    params = _jax_init(getattr(jconfig, f"{name}_config")())
    tm = trunners._cloud_model(cfg, torch.device("cpu"), 0)
    back = params_to_jax(params_from_jax(tm, params))
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])
    jf, tf = flat(params), flat(back)
    assert set(jf) == set(tf)
    for key, v in jf.items():
        np.testing.assert_array_equal(tf[key], v)
