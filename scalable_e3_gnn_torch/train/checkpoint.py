"""Checkpoint and resume, single process.

Counterpart of ``scalable_e3_gnn_tpu/train/checkpoint.py`` in its
single-process mode: ``<dir>/ckpt_<step>.npz`` written by atomic rename, and
a JSON manifest ``<dir>/ckpt_<step>.json``.  The file holds the whole
``TrainState``: every parameter (``params/<name>``), every tensor of the
optimizer's state (``opt/<index>/<key>``: Adam's moments and step count),
the step, and the data generator's state when the state has one
(``data_rng``, as JSON), so a run restored at step N and trained to 2N ends
bit for bit where a straight 2N run does.  The JAX module's per-process
shard files (multi-process, sharded state) are not ported.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

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


def save_checkpoint(directory: str, step: int, state: TrainState,
                    extra: Optional[dict] = None) -> str:
    """Write the checkpoint of ``state`` for ``step``; returns its path."""
    os.makedirs(directory, exist_ok=True)
    arrays = _arrays(state)
    path = os.path.join(directory, f"ckpt_{step}.npz")
    tmp = path + ".tmp.npz"  # ends in .npz so np.savez appends nothing
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    manifest = {"step": step, "num_leaves": len(arrays), "num_processes": 1,
                "leaves": sorted(arrays), "extra": extra or {}}
    mtmp = os.path.join(directory, f"ckpt_{step}.json.tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(directory, f"ckpt_{step}.json"))
    return path


def latest_step(directory: str) -> Optional[int]:
    """The highest step with a ``ckpt_<step>.npz`` in ``directory``, else None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if not (name.startswith("ckpt_") and name.endswith(".npz")):
            continue
        try:
            steps.append(int(name[5:-4]))
        except ValueError:
            pass
    return max(steps) if steps else None


def restore_checkpoint(directory: str, state_template: TrainState,
                       step: Optional[int] = None) -> Tuple[TrainState, int]:
    """Restore the checkpoint at ``step`` (the latest when None) into
    ``state_template`` in place: its parameters, its optimizer's state (on
    the parameters' device), its step and its data generator; returns
    ``(state, step)``.  Raises ``FileNotFoundError`` when no checkpoint
    exists, ``ValueError`` when the parameters differ from the template's."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    with np.load(os.path.join(directory, f"ckpt_{step}.npz")) as data:
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
