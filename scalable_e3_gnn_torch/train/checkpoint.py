"""Checkpoint and resume.

Counterpart of ``scalable_e3_gnn_tpu/train/checkpoint.py``.  A checkpoint
holds the whole ``TrainState``: every parameter (``params/<name>``), every
tensor of the optimizer's state (``opt/<index>/<key>``: Adam's moments and
step count), the step, and the data generator's state when the state has one
(``data_rng``, as JSON), so a run restored at step N and trained to 2N ends
bit for bit where a straight 2N run does.  Two modes, chosen by the
``torch.distributed`` world:

- one process: ``<dir>/ckpt_<step>.npz`` written by atomic rename, then the
  JSON manifest ``<dir>/ckpt_<step>.json``;
- a process group of more than one rank: every rank writes its own state to
  ``<dir>/ckpt_<step>.p<rank>.npz`` by atomic rename; after a barrier rank 0
  writes the manifest, with ``num_processes``.  A step counts
  (``latest_step``) once its manifest exists, so a step whose ranks did not
  all finish writing is never resumed.  Each rank restores its own file; a
  world size other than the manifest's, or a missing rank file, is an
  error, never a silent fresh start.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.multihost import world_size_and_rank
from .pipeline import TrainState

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _arrays(state: TrainState) -> Dict[str, np.ndarray]:
    out = {f"params/{nm}": p.detach().cpu().numpy() for nm, p in state.model.named_parameters()}
    for idx, entry in state.optimizer.state_dict()["state"].items():
        for key, val in entry.items():
            out[f"opt/{idx}/{key}"] = (val.detach().cpu().numpy() if torch.is_tensor(val)
                                       else np.asarray(val))
    out["step"] = np.asarray(state.step, np.int64)
    if state.data_rng is not None:
        out["data_rng"] = np.asarray(json.dumps(state.data_rng.bit_generator.state))
    return out


def _write_json(directory: str, name: str, obj: dict) -> None:
    tmp = os.path.join(directory, f"{name}.tmp")
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, os.path.join(directory, name))


def save_checkpoint(directory: str, step: int, state: TrainState,
                    extra: Optional[dict] = None, process_group=None) -> str:
    """Write the checkpoint of ``state`` for ``step``; returns the path this
    process wrote.  In a process group of more than one rank
    (``process_group``, the default group when None) every rank calls it:
    each writes ``ckpt_<step>.p<rank>.npz``, rank 0 the manifest once all
    have written, and every rank returns once the manifest is written."""
    os.makedirs(directory, exist_ok=True)
    arrays = _arrays(state)
    world, rank = world_size_and_rank(process_group)
    name = f"ckpt_{step}.npz" if world == 1 else f"ckpt_{step}.p{rank}.npz"
    path = os.path.join(directory, name)
    tmp = path + ".tmp.npz"  # ends in .npz so np.savez appends nothing
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    if world > 1:
        dist.barrier(process_group)
    if rank == 0:
        _write_json(directory, f"ckpt_{step}.json", {
            "step": step, "num_leaves": len(arrays), "num_processes": world,
            "leaves": sorted(arrays), "extra": extra or {}})
    if world > 1:
        dist.barrier(process_group)  # every rank returns with the step complete
    return path


def latest_step(directory: str) -> Optional[int]:
    """The highest step with a checkpoint in ``directory``, else None: a
    ``ckpt_<step>.npz``, or per-rank ``ckpt_<step>.p<rank>.npz`` files with
    their manifest."""
    if not os.path.isdir(directory):
        return None
    names = set(os.listdir(directory))
    steps = []
    for name in names:
        if not (name.startswith("ckpt_") and name.endswith(".npz")):
            continue
        stem, per_rank = name[5:-4], False
        if ".p" in stem:  # per-rank file ckpt_<step>.p<rank>.npz
            stem, per_rank = stem.split(".p")[0], True
        try:
            step = int(stem)
        except ValueError:
            continue
        if not per_rank or f"ckpt_{step}.json" in names:
            steps.append(step)
    return max(steps) if steps else None


def restore_checkpoint(directory: str, state_template: TrainState,
                       step: Optional[int] = None,
                       process_group=None) -> Tuple[TrainState, int]:
    """Restore the checkpoint at ``step`` (the latest when None) into
    ``state_template`` in place: its parameters, its optimizer's state (on
    the parameters' device), its step and its data generator; returns
    ``(state, step)``.  In a process group of more than one rank each rank
    reads its own file.  Raises ``FileNotFoundError`` when no checkpoint
    exists; ``ValueError`` when the parameters differ from the template's,
    when the world size differs from the manifest's, or when this rank's file
    of a complete checkpoint is missing."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    world, rank = world_size_and_rank(process_group)
    manifest = os.path.join(directory, f"ckpt_{step}.json")
    name = f"ckpt_{step}.npz" if world == 1 else f"ckpt_{step}.p{rank}.npz"
    path = os.path.join(directory, name)
    if not os.path.exists(manifest):
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint of step {step} in {directory}")
        saved_world = 1
    else:
        with open(manifest) as f:
            saved_world = int(json.load(f).get("num_processes", 1))
    if saved_world != world:
        raise ValueError(f"checkpoint {step} in {directory} was written by {saved_world} "
                         f"processes, not {world}: restore under the world that saved it")
    if not os.path.exists(path):
        raise ValueError(f"{path} is missing: the checkpoint of step {step} is incomplete")
    with np.load(path) as data:
        params = dict(state_template.model.named_parameters())
        saved = {k[len("params/"):] for k in data.files if k.startswith("params/")}
        if saved != set(params):
            raise ValueError(f"checkpoint parameters {sorted(saved ^ set(params))} differ "
                             "from the template's")
        with torch.no_grad():
            for nm, p in params.items():
                arr = data[f"params/{nm}"]
                if tuple(arr.shape) != tuple(p.shape):
                    raise ValueError(f"{nm}: shape {arr.shape} != {tuple(p.shape)}")
                p.copy_(torch.from_numpy(arr))
        opt_state: Dict[int, dict] = {}
        for k in data.files:
            if k.startswith("opt/"):
                _, idx, key = k.split("/", 2)
                opt_state.setdefault(int(idx), {})[key] = torch.from_numpy(data[k].copy())
        sd = state_template.optimizer.state_dict()
        sd["state"] = opt_state
        state_template.optimizer.load_state_dict(sd)
        state_template.step = int(data["step"])
        if "data_rng" in data.files:
            if state_template.data_rng is None:
                state_template.data_rng = np.random.default_rng()
            state_template.data_rng.bit_generator.state = json.loads(str(data["data_rng"]))
    return state_template, step
