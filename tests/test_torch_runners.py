"""PyTorch port, the config-1 and config-2 runners and what they stand on:
the train state, checkpoints, metrics and configs, against the JAX package.

- ``run_nbody`` and ``run_qm9`` from JAX's initial weights: the 3-step loss
  curves within 1e-5 relative of the JAX runners' (fp32 gradients through
  3-4 layers summed in another order, then Adam), N-body's gradient norms
  and the held-out metrics within 1e-4 relative (a norm of the gradients
  themselves, one Adam step further from the shared weights), the result
  dicts' keys equal;
- the runners on the GPU by default: without one they raise unless given
  ``device="cpu"``;
- checkpoints as ``tests/test_checkpoint.py`` holds JAX's: train 2N steps
  = train N, save, restore, train N, bit for bit (parameters and Adam
  state), through the pipeline and through ``run_nbody(resume=True)``;
  ``latest_step`` of many; a missing directory raises; the data generator's
  state comes back;
- ``MetricsLogger`` writes JAX's records; the configs equal JAX's.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from scalable_e3_gnn_tpu.core.irreps import Irreps as JIrreps
from scalable_e3_gnn_tpu.models.segnn import SEGNN as JSEGNN
from scalable_e3_gnn_tpu.train import metrics as jmetrics
from scalable_e3_gnn_tpu.train import runners as jrunners
from scalable_e3_gnn_tpu.utils import config as jconfig
from scalable_e3_gnn_torch.graph.batching import batch_same_size
from scalable_e3_gnn_torch.models.segnn import SEGNN
from scalable_e3_gnn_torch.train import checkpoint as tckpt
from scalable_e3_gnn_torch.train import metrics as tmetrics
from scalable_e3_gnn_torch.train import runners as trunners
from scalable_e3_gnn_torch.train.pipeline import make_train_state, make_train_step, mse_loss
from scalable_e3_gnn_torch.utils import config as tconfig
from scalable_e3_gnn_torch.utils.params import params_from_jax, params_to_jax


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: these shapes are small, and the suite
    runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_jax_cache(monkeypatch):
    """The JAX runners' persistent compile cache stays off (it would write
    outside the checkout)."""
    monkeypatch.setattr(jrunners, "_setup", lambda: None)


def _jax_init(cfg, task):
    """The JAX runner's model and initial weights for ``cfg``."""
    m = cfg.model
    kw = dict(vel_attr=m.vel_attr) if task == "node" else dict(task="graph")
    jm = JSEGNN(JIrreps(m.input_irreps), JIrreps(m.hidden_irreps), JIrreps(m.output_irreps),
                num_layers=m.num_layers, **kw)
    return jax.tree.map(np.asarray, jm.init(jax.random.key(cfg.train.seed)))


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("which", ["nbody", "qm9"])
def test_runner_curves_match_jax(which, tmp_path, monkeypatch, no_jax_cache):
    cfg = getattr(tconfig, f"{which}_config")()
    jcfg = getattr(jconfig, f"{which}_config")()
    task = "node" if which == "nbody" else "graph"
    params = _jax_init(jcfg, task)
    make = trunners._model
    monkeypatch.setattr(trunners, "_model",
                        lambda c, d, task="node": params_from_jax(make(c, d, task), params))
    kw = dict(steps=3, graphs=8) if which == "nbody" else dict(steps=3, molecules=16,
                                                                  batch_size=8)
    jlog, tlog = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    want = getattr(jrunners, f"run_{which}")(cfg=jcfg, log=jlog, **kw)
    got = getattr(trunners, f"run_{which}")(cfg=cfg, log=tlog, device="cpu", **kw)
    assert list(got) == list(want)
    jr, tr = _records(jlog), _records(tlog)
    assert [set(r) for r in tr] == [set(r) for r in jr]
    curve = lambda recs, k: np.array([r[k] for r in recs[:3]])
    np.testing.assert_allclose(curve(tr, "loss"), curve(jr, "loss"), rtol=1e-5, atol=0)
    assert curve(jr, "loss")[2] < curve(jr, "loss")[0]  # the loss moves
    if which == "nbody":
        np.testing.assert_allclose(curve(tr, "grad_norm"), curve(jr, "grad_norm"), rtol=1e-4)
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("which", ["nbody", "qm9"])
def test_params_from_jax_loads_config_models(which):
    """``SEGNN.init``'s dict of configs 1 (``vel_attr``) and 2 (``task=
    "graph"``) loads unchanged, key for key and bit for bit."""
    jcfg = getattr(jconfig, f"{which}_config")()
    task = "node" if which == "nbody" else "graph"
    params = _jax_init(jcfg, task)
    tm = trunners._model(getattr(tconfig, f"{which}_config")(), torch.device("cpu"), task)
    back = params_to_jax(params_from_jax(tm, params))
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])
    jf, tf = flat(params), flat(back)
    assert set(jf) == set(tf)
    for k, v in jf.items():
        np.testing.assert_array_equal(tf[k], v)


def test_runners_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trunners.run_nbody(steps=1, graphs=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trunners.run_qm9(steps=1, molecules=4, batch_size=4)


def _small(seed=0):
    """tests/test_checkpoint.py's setup: 8 graphs, a 1-layer model, Adam."""
    ds = trunners.generate_dataset(8, num_steps=20, seed=0)
    feats = np.concatenate([(ds["vel0"] ** 2).sum(-1, keepdims=True), ds["charges"][..., None],
                            ds["vel0"]], -1)
    s, r = trunners.make_fully_connected_edges(5)
    g = batch_same_size(feats, ds["pos0"], s, r, device="cpu").with_plans()
    batch = (g, torch.from_numpy(ds["vel0"].reshape(-1, 3)),
             torch.from_numpy(ds["disp"].reshape(-1, 3)))
    model = SEGNN("2x0e+1x1o", "8x0e+8x1o", "1x1o", num_layers=1, device="cpu",
                  generator=torch.Generator().manual_seed(seed))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_train_step(model, lambda m, g_, v, t: mse_loss(m(g_, v), t), opt)
    return model, opt, step, batch


def test_resume_exactness(tmp_path):
    model, opt, step, batch = _small()
    for _ in range(6):
        step(*batch)

    model2, opt2, step2, _ = _small()
    state2 = make_train_state(model2, opt2)
    for _ in range(3):
        step2(*batch)
        state2.step += 1
    tckpt.save_checkpoint(str(tmp_path), 3, state2)
    assert tckpt.latest_step(str(tmp_path)) == 3

    model3, opt3, step3, _ = _small(seed=1)  # other weights: all of them come from the file
    restored, at = tckpt.restore_checkpoint(str(tmp_path), make_train_state(model3, opt3))
    assert at == 3 and restored.step == 3
    for _ in range(3):
        step3(*batch)
    for a, b in zip(model.parameters(), model3.parameters()):
        assert torch.equal(a, b)
    for sa, sb in zip(opt.state.values(), opt3.state.values()):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_run_nbody_resume_bitwise(tmp_path):
    """run_nbody: 4 straight steps = 2 steps, a checkpoint, then resumed to 4."""
    cfg = tconfig.nbody_config()
    cfg.model.num_layers = 1
    cfg.train.checkpoint_every = 2
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    straight = trunners.run_nbody(cfg, steps=4, graphs=4, ckpt_dir=a, device="cpu")
    trunners.run_nbody(cfg, steps=2, graphs=4, ckpt_dir=b, device="cpu")
    assert tckpt.latest_step(b) == 2
    resumed = trunners.run_nbody(cfg, steps=4, graphs=4, ckpt_dir=b, resume=True, device="cpu")
    assert resumed == straight
    fa, fb = np.load(f"{a}/ckpt_4.npz"), np.load(f"{b}/ckpt_4.npz")
    assert sorted(fa.files) == sorted(fb.files)
    for k in fa.files:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_latest_of_many(tmp_path):
    model, opt, _, _ = _small()
    state = make_train_state(model, opt)
    for s in (1, 5, 3):
        tckpt.save_checkpoint(str(tmp_path), s, state)
    assert tckpt.latest_step(str(tmp_path)) == 5
    _, at = tckpt.restore_checkpoint(str(tmp_path), state)
    assert at == 5
    man = json.loads((tmp_path / "ckpt_5.json").read_text())
    assert man["step"] == 5 and man["num_processes"] == 1


def test_restore_missing_raises(tmp_path):
    model, opt, _, _ = _small()
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "nope"), make_train_state(model, opt))
    assert tckpt.latest_step(str(tmp_path / "nope")) is None


def test_data_rng_round_trip(tmp_path):
    model, opt, _, _ = _small()
    state = make_train_state(model, opt, data_rng=np.random.default_rng(11))
    state.data_rng.random(5)
    tckpt.save_checkpoint(str(tmp_path), 1, state)
    want = state.data_rng.random(4)
    back, _ = tckpt.restore_checkpoint(str(tmp_path), make_train_state(model, opt))
    np.testing.assert_array_equal(back.data_rng.random(4), want)


def test_metrics_logger_matches_jax(tmp_path):
    recs = []
    for mod, name in ((jmetrics, "j"), (tmetrics, "t")):
        path = str(tmp_path / f"{name}.jsonl")
        log = mod.MetricsLogger(path, stdout_every=0)
        log.log(0, {"loss": np.float32(0.5), "grad_norm": 2}, edges=100)
        log.log(1, {"eval_mae": 0.25})
        log.close()
        recs.append(_records(path))
    for a, b in zip(*recs):
        assert list(a) == list(b)
        assert {k: v for k, v in a.items() if k not in ("time_s", "edges_per_s")} == \
            {k: v for k, v in b.items() if k not in ("time_s", "edges_per_s")}
    t = tmetrics.MetricsLogger(None, stdout_every=0)
    t.log(0, {"loss": torch.tensor(1.5)})  # a tensor scalar reads as a float


def test_configs_match_jax():
    for name in ("nbody_config", "qm9_config", "cloud100k_config", "cloud1m_config",
                 "cloud10m_config"):
        assert (dataclasses.asdict(getattr(tconfig, name)())
                == dataclasses.asdict(getattr(jconfig, name)())), name
