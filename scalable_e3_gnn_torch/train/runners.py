"""Experiment runners: one function per evaluation-ladder config.

Counterpart of ``scalable_e3_gnn_tpu/train/runners.py``: ``run_nbody``
(config 1, charged N-body), ``run_qm9`` (config 2, QM9-style),
``run_qm9_protocol`` (the literature QM9 evaluation) and ``run_pointcloud``
(configs 3-5, point clouds), with the same arguments plus ``device`` (the
GPU unless given: they raise without one unless ``device="cpu"``), the same
data, model, optimizer, loop, metrics records, checkpoints and held-out
evaluation, and the same result dicts.  The model's weights come from a
``torch.Generator`` seeded with ``cfg.train.seed`` (``seed`` for the
protocol and the point clouds: the JAX runners' ``jax.random.key(seed)``),
so the same seed gives the same weights on the CPU and on the GPU.

``run_pointcloud`` runs the hand-written message kernels on the GPU for
every cloud config: the model's layout resolves to ``"cm"`` (as the JAX
``SEGNN`` resolves ``layout=None``) before the runner asks for the kernels.
The JAX runner tests the config's unresolved layout, so on a TPU only
``cloud1m`` ran its kernels; the math is the same either way.  Off the GPU
the runner takes the plain message path, as the JAX runner does off the TPU.

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
from ..data.qm9 import (batch_molecules, generate_molecules, load_qm9, load_uncharacterized,
                        split_qm9, target_unit)
from ..graph.batching import batch_same_size
from ..graph.container import DenseEdgeGraph
from ..graph.octree import build_octree
from ..graph.radius import (radius_graph_cell, radius_graph_cell_segments,
                            search_level_for_radius, suggest_cell_capacity)
from ..models.segnn import SEGNN
from ..utils.config import cloud100k_config, nbody_config, qm9_config
from ..utils.device import resolve_device
from .checkpoint import restore_checkpoint, save_checkpoint
from .metrics import MetricsLogger
from .pipeline import make_train_state, make_train_step, mse_loss

__all__ = ["RunnerSetup", "nbody_setup", "qm9_setup", "run_nbody", "run_qm9",
           "run_qm9_protocol", "run_pointcloud"]

# run_pointcloud's size thresholds (the JAX runner's values)
_SEGMENT_POINTS = 1_000_000  # above: the segmented "approx" build, n // this segments (>= 2)
_LARGE_POINTS = 2_000_000  # above: no symmetrize, node blocks, remat_layers=2, chunked attrs
_BLOCK_POINTS = 400_000  # node block of the kernel and lmax=1 paths above _LARGE_POINTS
_PLAIN_BLOCK_POINTS = 125_000  # node block of the plain lmax >= 2 path, any size
_REMAT_KERNEL_POINTS = 500_000  # from here (under cfg.model.remat): remat_kernel
_EVAL_POINTS = 500_000  # up to: the held-out cloud


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


def _model(cfg, device, task: str = "node", seed: Optional[int] = None) -> SEGNN:
    """The runner's SEGNN on ``device``, its weights from ``seed`` (default
    ``cfg.train.seed``)."""
    m = cfg.model
    seed = cfg.train.seed if seed is None else seed
    return SEGNN(m.input_irreps, m.hidden_irreps, m.output_irreps, num_layers=m.num_layers,
                 vel_attr=m.vel_attr if task == "node" else False, task=task, device=device,
                 generator=torch.Generator().manual_seed(seed))


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


def run_qm9_protocol(data_path: str, target: str = "U0", cfg=None, steps: Optional[int] = None,
                     epochs: Optional[int] = None, molecules: Optional[int] = None,
                     batch_size: Optional[int] = None, seed: int = 0, log: Optional[str] = None,
                     ckpt_dir: Optional[str] = None, device=None) -> dict:
    """The literature-comparable QM9 evaluation on a dsgdb9nsd download at
    ``data_path``: every ``*.xyz`` parsed, the molecules listed in a
    companion ``uncharacterized.txt`` dropped; one shuffle at ``seed``, then
    110k train / 10k val / the rest test (proportional for fewer molecules);
    the target z-scored by the train split's mean and std, predictions
    un-standardised before scoring; MAEs in the literature unit
    (``data.qm9.target_unit``: Hartree energies in meV).  ``epochs``
    (default 1 when neither is given) sweeps the train split in shuffled
    whole batches; ``steps`` counts minibatches instead."""
    dev = resolve_device(device)
    cfg = cfg or qm9_config()
    bs = batch_size or cfg.train.batch_size
    excl = load_uncharacterized(data_path)
    mols = load_qm9(data_path, target=target, limit=molecules, exclude=excl)
    train, val, test = split_qm9(mols, seed=seed)
    tr_t = np.asarray([m["target"] for m in train], np.float64)
    mean, std = float(tr_t.mean()), float(tr_t.std() + 1e-12)
    factor, unit = target_unit(target)
    batch = lambda ms: batch_molecules(ms, radius=cfg.graph.radius,
                                       max_neighbors=cfg.graph.max_neighbors, device=dev)
    train_b = []
    for i in range(0, len(train) - bs + 1, bs):
        g, t = batch(train[i:i + bs])
        train_b.append((g.with_plans(), (t - mean) / std))
    model = _model(cfg, dev, task="graph", seed=seed)
    opt = _adam(model, cfg)
    step = make_train_step(model, lambda m, g, t: torch.mean((m(g)[:, 0] - t) ** 2), opt)
    state = make_train_state(model, opt)
    if steps is None:
        steps = (epochs or 1) * len(train_b)
    logger = MetricsLogger(log, stdout_every=max(1, steps // 10))
    order = np.random.default_rng(seed + 1)
    idx = order.permutation(len(train_b))
    m = {"loss": float("inf")}
    for i in range(steps):
        if i % len(train_b) == 0 and i:
            idx = order.permutation(len(train_b))
        m = step(*train_b[int(idx[i % len(train_b)])])
        state.step = i + 1
        logger.log(i, {"loss": m["loss"]})
        if ckpt_dir and (i + 1) % cfg.train.checkpoint_every == 0:
            save_checkpoint(ckpt_dir, i + 1, state)

    def mae_of(ms) -> float:
        errs = []
        for i in range(0, len(ms), bs):
            chunk = ms[i:i + bs]
            g, t = batch(chunk)
            with torch.no_grad():
                pred = model(g.with_plans())[:, 0].cpu().numpy()
            pred = pred[:len(chunk)] * std + mean
            errs.append(np.abs(pred - t.cpu().numpy()[:len(chunk)]))
        return float(np.concatenate(errs).mean() * factor) if errs else float("nan")

    val_mae, test_mae = mae_of(val), mae_of(test)
    logger.log(steps, {"val_mae": val_mae, "test_mae": test_mae})
    logger.close()
    return {"target": target, "unit": unit, "final_loss": float(m["loss"]), "val_mae": val_mae,
            "test_mae": test_mae, "n_train": len(train), "n_val": len(val), "n_test": len(test),
            "n_excluded": len(excl), "standardize_mean": mean, "standardize_std": std,
            "steps": steps}


def _use_kernels(cfg, dev) -> bool:
    """The message kernels on the GPU wherever the resolved layout is "cm"
    (the module docstring); the plain path elsewhere."""
    return dev.type == "cuda" and (cfg.model.layout or "cm") == "cm"


def _cloud_model(cfg, dev, seed: int, **ladder) -> SEGNN:
    """``run_pointcloud``'s SEGNN on ``dev``: the config's widths with the
    runner's memory ladder (``use_pallas``, ``edge_chunks``, ``remat_kernel``,
    ``remat_layers``), its weights from ``seed``."""
    m = cfg.model
    return SEGNN(m.input_irreps, m.hidden_irreps, m.output_irreps, lmax_attr=m.lmax_attr,
                 num_layers=m.num_layers, remat=m.remat, layout=m.layout, device=dev,
                 generator=torch.Generator().manual_seed(seed), **ladder)


def _cloud_graph(pts, masses, radius, lo, hi, k, levels, capacity, symmetrize, dev,
                 segments: int = 0):
    """A cloud's graph and target on ``dev``: the octree (``levels``), the
    cell radius graph (``segments`` > 0: the segmented build with the
    "approx" selection), the dense graph with node features [m, 1, 0, 0, 0]
    in Morton order, and the target, the local mass dipole sum_j m_j (x_j -
    x_i) over the valid slots.  Returns (graph, target, cell capacity)."""
    n = pts.shape[0]
    tree = build_octree(pts, lo, hi, num_levels=levels, device=dev)
    capacity = capacity or suggest_cell_capacity(tree, radius, lo, hi)
    if segments:
        edges = radius_graph_cell_segments(tree, radius, lo, hi, max_neighbors=k,
                                           cell_capacity=capacity, num_segments=segments,
                                           selection="approx")
    else:
        edges = radius_graph_cell(tree, radius, lo, hi, max_neighbors=k, cell_capacity=capacity)
    ms = torch.from_numpy(masses).to(dev)[tree.order.long()]
    feats = torch.cat([ms, torch.ones_like(ms), torch.zeros((n, 3), device=dev)], dim=-1)
    graph = DenseEdgeGraph.from_radius_edges(feats, tree.points, edges, symmetrize=symmetrize)
    del tree, edges
    rel = graph.rel_positions()
    mj = ms[:, 0][torch.clamp(graph.senders, max=n - 1).long()]
    target = (rel * torch.where(graph.edge_mask, mj, 0.0)[..., None]).sum(dim=1)
    return graph, target, capacity


def _to_bf16(graph, attrs):
    """bf16 node features and attributes."""
    bf = torch.bfloat16
    return graph._replace(nodes=graph.nodes.to(bf)), tuple(a.to(bf) for a in attrs)


def run_pointcloud(cfg=None, points: Optional[int] = None, steps: Optional[int] = None,
                   log: Optional[str] = None, seed: int = 0, device=None) -> dict:
    """Configs 3-5 on one device: uniform points and masses from ``seed``,
    octree, cell radius graph, dense graph, then ``steps`` train steps of
    MSE on the mass-dipole target with Adam (bf16 compute on fp32 masters
    under ``cfg.train.bf16``), and a held-out cloud's MSE up to 500k points.

    ``points`` overrides the 100k default and then scales the radius to keep
    the density (0.04 at 100k).  Up to 1M points one cell build, above it
    the segmented build (``max(2, n // 1M)`` segments, the "approx"
    selection); up to 2M points a symmetrized graph and whole-graph
    attributes, above it node blocks of 400k, ``remat_layers=2`` and
    chunked geo-only attributes; ``remat_kernel`` from 500k points under
    ``cfg.model.remat``.  On the GPU every cloud config runs the message
    kernels (the module docstring)."""
    dev = resolve_device(device)
    cfg = cfg or cloud100k_config()
    n = points or 100_000
    steps = steps if steps is not None else cfg.train.num_steps
    radius = 0.04 * (100_000 / n) ** (1 / 3) if points else cfg.graph.radius
    lo, hi = (cfg.graph.bounds[0],) * 3, (cfg.graph.bounds[1],) * 3
    k = cfg.graph.max_neighbors
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 3)).astype(np.float32)
    masses = rng.random((n, 1)).astype(np.float32)
    # the tree must contain the search level (cell side >= radius)
    levels = max(4, search_level_for_radius(radius, lo, hi) + 1)
    large = n > _LARGE_POINTS
    symmetrize = not large
    segments = max(2, n // _SEGMENT_POINTS) if n > _SEGMENT_POINTS else 0
    graph, target, capacity = _cloud_graph(pts, masses, radius, lo, hi, k, levels,
                                           cfg.graph.cell_capacity, symmetrize, dev, segments)
    del pts, masses

    use_pallas = _use_kernels(cfg, dev)
    if use_pallas or cfg.model.lmax_attr == 1:
        chunks = max(1, n // _BLOCK_POINTS) if large else 1
    else:
        chunks = max(1, n // _PLAIN_BLOCK_POINTS)
    model = _cloud_model(cfg, dev, seed, use_pallas=use_pallas, edge_chunks=chunks,
                         remat_kernel=cfg.model.remat and n >= _REMAT_KERNEL_POINTS,
                         remat_layers=2 if large else 0)
    bf16 = cfg.train.bf16
    with torch.no_grad():
        if large:
            # geo-only attributes built in node slabs: whole-graph fp32
            # spherical harmonics would hold 5.8 GB at 10M points
            attrs = model.compute_attributes_dense_chunked(
                graph.positions, graph.senders, graph.edge_mask,
                dtype=torch.bfloat16 if bf16 else torch.float32)
            if bf16:
                graph = graph._replace(nodes=graph.nodes.to(torch.bfloat16))
        else:
            attrs = model.compute_attributes_dense(graph)
            if bf16:
                graph, attrs = _to_bf16(graph, attrs)

    def loss_fn(m, g, a, t):
        if bf16:
            p = {nm: w.to(torch.bfloat16) for nm, w in m.named_parameters()}
            out = torch.func.functional_call(m, p, (g,), {"attrs": a})
        else:
            out = m(g, attrs=a)
        return mse_loss(out.float(), t)

    opt = _adam(model, cfg)
    step = make_train_step(model, loss_fn, opt)
    logger = MetricsLogger(log, stdout_every=1)
    n_edges = int(graph.edge_mask.sum())
    m = {"loss": float("inf")}
    for i in range(steps):
        m = step(graph, attrs, target)
        logger.log(i, {"loss": m["loss"]}, edges=n_edges)
    out = {"final_loss": float(m["loss"]), "steps": steps, "edges": n_edges}
    del graph, attrs, target
    if n <= _EVAL_POINTS:
        # held-out: a fresh cloud from the next seed, the same force law
        rng_e = np.random.default_rng(seed + 1)
        pts_e = rng_e.random((n, 3)).astype(np.float32)
        masses_e = rng_e.random((n, 1)).astype(np.float32)
        graph_e, target_e, _ = _cloud_graph(pts_e, masses_e, radius, lo, hi, k, levels,
                                            capacity, symmetrize, dev)
        with torch.no_grad():
            attrs_e = model.compute_attributes_dense(graph_e)
            if bf16:
                graph_e, attrs_e = _to_bf16(graph_e, attrs_e)
                p = {nm: w.to(torch.bfloat16) for nm, w in model.named_parameters()}
                pred = torch.func.functional_call(model, p, (graph_e,), {"attrs": attrs_e})
            else:
                pred = model(graph_e, attrs=attrs_e)
            out["eval_mse"] = float(torch.mean((pred.float() - target_e) ** 2))
        logger.log(steps, {"eval_mse": out["eval_mse"]})
    logger.close()
    return out
