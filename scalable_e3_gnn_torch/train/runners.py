"""Experiment runners: config 1 (charged N-body) and config 2 (QM9-style).

Counterpart of ``scalable_e3_gnn_tpu/train/runners.py::run_nbody`` and
``run_qm9``: the same arguments plus ``device`` (the GPU unless given: they
raise without one unless ``device="cpu"``), the same data, model, optimizer,
loop, metrics records, checkpoints and held-out evaluation, and the same
result dicts.  The model's weights come from a ``torch.Generator`` seeded
with ``cfg.train.seed`` (the JAX runners' ``jax.random.key(seed)``), so the
same seed gives the same weights on the CPU and on the GPU.

``nbody_setup`` and ``qm9_setup`` build what a runner trains (model,
optimizer, train step, batches, held-out evaluation) without running it,
for callers that time the step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from ..data.nbody import generate_dataset, make_fully_connected_edges
from ..data.qm9 import batch_molecules, generate_molecules, load_qm9
from ..graph.batching import batch_same_size
from ..models.segnn import SEGNN
from ..utils.config import nbody_config, qm9_config
from ..utils.device import resolve_device
from .checkpoint import restore_checkpoint, save_checkpoint
from .metrics import MetricsLogger
from .pipeline import make_train_state, make_train_step, mse_loss

__all__ = ["RunnerSetup", "nbody_setup", "qm9_setup", "run_nbody", "run_qm9"]


@dataclasses.dataclass
class RunnerSetup:
    """A runner's pieces: ``step(*batches[i]) -> {"loss", ...}`` updates
    ``model`` through ``optimizer``; ``evaluate()`` returns the held-out
    metrics of the result dict; ``edges`` counts a batch's valid edges."""

    model: SEGNN
    optimizer: torch.optim.Optimizer
    step: Callable
    batches: List[tuple]
    evaluate: Callable[[], dict]
    edges: int = 0


def _model(cfg, device, task: str = "node") -> SEGNN:
    """The runner's SEGNN on ``device``, its weights from ``cfg.train.seed``."""
    m = cfg.model
    return SEGNN(m.input_irreps, m.hidden_irreps, m.output_irreps, num_layers=m.num_layers,
                 vel_attr=m.vel_attr if task == "node" else False, task=task, device=device,
                 generator=torch.Generator().manual_seed(cfg.train.seed))


def _adam(model, cfg) -> torch.optim.Optimizer:
    """``optax.adam(lr)``: eps outside the root, bias correction on."""
    return torch.optim.Adam(model.parameters(), lr=cfg.train.learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


def _nbody_batch(graphs: int, seed: int, device):
    """(graph, velocities, target displacements) of ``graphs`` fresh
    5-particle systems from ``seed``, fully connected, batched."""
    ds = generate_dataset(graphs, num_steps=500, seed=seed)
    n = ds["pos0"].shape[1]
    feats = np.concatenate(
        [(ds["vel0"] ** 2).sum(-1, keepdims=True), ds["charges"][..., None], ds["vel0"]], -1)
    s, r = make_fully_connected_edges(n)
    graph = batch_same_size(feats, ds["pos0"], s, r, device=device).with_plans()
    t = lambda a: torch.from_numpy(a.reshape(-1, 3)).to(device)
    return graph, t(ds["vel0"]), t(ds["disp"])


def nbody_setup(cfg=None, graphs: int = 256, device=None) -> RunnerSetup:
    """Config 1's pieces: ``graphs`` trajectories from ``cfg.train.seed``, the
    SEGNN with ``vel_attr``, Adam, MSE on the displacements; held out,
    ``max(graphs // 5, 16)`` trajectories from the next seed."""
    dev = resolve_device(device)
    cfg = cfg or nbody_config()
    graph, vel, target = _nbody_batch(graphs, cfg.train.seed, dev)
    model = _model(cfg, dev)
    opt = _adam(model, cfg)
    step = make_train_step(model, lambda m, g, v, t: mse_loss(m(g, v), t), opt)
    n_eval = max(graphs // 5, 16)

    def evaluate() -> dict:
        graph_e, vel_e, target_e = _nbody_batch(n_eval, cfg.train.seed + 1, dev)
        with torch.no_grad():
            err = model(graph_e, vel_e) - target_e
        return {"eval_mse": float(torch.mean(err ** 2)),
                "eval_disp_rmse": float(torch.sqrt(torch.mean(torch.sum(err ** 2, -1)))),
                "eval_graphs": n_eval}

    return RunnerSetup(model, opt, step, [(graph, vel, target)], evaluate,
                       int(graph.edge_mask.sum()))


def run_nbody(cfg=None, steps: Optional[int] = None, graphs: int = 256,
              ckpt_dir: Optional[str] = None, log: Optional[str] = None, resume: bool = False,
              device=None) -> dict:
    """Config 1: charged N-body, fully connected 5-particle graphs; ``resume``
    continues from the latest checkpoint in ``ckpt_dir``."""
    cfg = cfg or nbody_config()
    steps = steps if steps is not None else cfg.train.num_steps
    setup = nbody_setup(cfg, graphs, device)
    state = make_train_state(setup.model, setup.optimizer)
    start = 0
    if resume and ckpt_dir:
        try:
            state, start = restore_checkpoint(ckpt_dir, state)
        except FileNotFoundError:
            pass
    logger = MetricsLogger(log, stdout_every=max(1, steps // 10))
    m = {"loss": float("inf")}
    for i in range(start, steps):
        m = setup.step(*setup.batches[0])
        state.step = i + 1
        logger.log(i, {"loss": m["loss"], "grad_norm": m["grad_norm"]}, edges=setup.edges)
        if ckpt_dir and (i + 1) % cfg.train.checkpoint_every == 0:
            save_checkpoint(ckpt_dir, i + 1, state)
    ev = setup.evaluate()
    logger.log(steps, {"eval_mse": ev["eval_mse"], "eval_disp_rmse": ev["eval_disp_rmse"]})
    logger.close()
    return {"final_loss": float(m["loss"]), **ev, "steps": steps, "edges": setup.edges}


def qm9_setup(cfg=None, molecules: int = 512, batch_size: Optional[int] = None,
              data_path: Optional[str] = None, target: str = "U0", device=None) -> RunnerSetup:
    """Config 2's pieces: ``molecules`` from ``data_path`` (``load_qm9``) or
    the synthetic stand-in at ``cfg.train.seed``, in padded batches of
    ``batch_size``; the graph-task SEGNN, Adam, MSE on the targets; held
    out, per-graph MAE over whole batches of ``max(molecules // 5, 32)``
    molecules (the download's tail, or the stand-in's next seed)."""
    dev = resolve_device(device)
    cfg = cfg or qm9_config()
    bs = batch_size or cfg.train.batch_size
    n_eval = max(molecules // 5, 32)
    if data_path:
        allm = load_qm9(data_path, target=target, limit=molecules + n_eval)
        mols, mols_eval = allm[:molecules], allm[molecules:]
    else:
        mols = generate_molecules(molecules, seed=cfg.train.seed)
        mols_eval = None
    batch = lambda ms: batch_molecules(ms, radius=cfg.graph.radius,
                                       max_neighbors=cfg.graph.max_neighbors, device=dev)
    batches = []
    for i in range(0, max(len(mols) - bs + 1, 1), bs):
        g, t = batch(mols[i:i + bs])
        batches.append((g.with_plans(), t))
    model = _model(cfg, dev, task="graph")
    opt = _adam(model, cfg)
    step = make_train_step(model, lambda m, g, t: torch.mean((m(g)[:, 0] - t) ** 2), opt)

    def evaluate() -> dict:
        mols_e = mols_eval if mols_eval else generate_molecules(n_eval, seed=cfg.train.seed + 1)
        abs_errs = []
        for i in range(0, len(mols_e), bs):
            chunk = mols_e[i:i + bs]
            if len(chunk) < bs:
                break
            g, t = batch(chunk)
            with torch.no_grad():
                pred = model(g.with_plans())[:, 0]
            abs_errs.append(np.abs(pred.cpu().numpy() - t.cpu().numpy()))
        mae = float(np.concatenate(abs_errs).mean()) if abs_errs else float("nan")
        return {"eval_mae": mae, "eval_molecules": n_eval}

    return RunnerSetup(model, opt, step, batches, evaluate)


def run_qm9(cfg=None, steps: Optional[int] = None, molecules: int = 512,
            batch_size: Optional[int] = None, ckpt_dir: Optional[str] = None,
            log: Optional[str] = None, data_path: Optional[str] = None, target: str = "U0",
            device=None) -> dict:
    """Config 2: QM9-style molecular property regression, padded batches,
    the batches taken in turn.  ``data_path``: a directory of real QM9 .xyz
    files (``data.qm9.load_qm9``); by default the synthetic stand-in."""
    cfg = cfg or qm9_config()
    steps = steps if steps is not None else cfg.train.num_steps
    setup = qm9_setup(cfg, molecules, batch_size, data_path, target, device)
    state = make_train_state(setup.model, setup.optimizer)
    logger = MetricsLogger(log, stdout_every=max(1, steps // 10))
    m = {"loss": float("inf")}
    for i in range(steps):
        m = setup.step(*setup.batches[i % len(setup.batches)])
        state.step = i + 1
        logger.log(i, {"loss": m["loss"]})
        if ckpt_dir and (i + 1) % cfg.train.checkpoint_every == 0:
            save_checkpoint(ckpt_dir, i + 1, state)
    ev = setup.evaluate()
    logger.log(steps, {"eval_mae": ev["eval_mae"]})
    logger.close()
    return {"final_loss": float(m["loss"]), **ev, "steps": steps}
