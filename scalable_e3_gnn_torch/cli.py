"""Command-line interface: ``python -m scalable_e3_gnn_torch <cmd> ...``.

Counterpart of ``scalable_e3_gnn_tpu/cli.py``, with the same subcommands
and arguments plus ``--device``:

  train     --config {nbody,qm9,cloud100k,cloud1m,cloud10m} [overrides]
  qm9-eval  --data-dir DIR [--target U0]   literature-protocol QM9 MAE
  info                      device/platform/version report
  configs                   list the evaluation-ladder configs

``train`` and ``qm9-eval`` run on the GPU unless ``--device`` names another
device (``--device cpu``); without a GPU and without ``--device`` they exit
with the device message.  Each prints one JSON line of results.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional

from . import __version__
from .utils import config as config_mod

_CONFIGS = {
    "nbody": config_mod.nbody_config,
    "qm9": config_mod.qm9_config,
    "cloud100k": config_mod.cloud100k_config,
    "cloud1m": config_mod.cloud1m_config,
    "cloud10m": config_mod.cloud10m_config,
}
_CLOUD_POINTS = {"cloud100k": 100_000, "cloud1m": 1_000_000, "cloud10m": 10_000_000}


def _cmd_train(args) -> int:
    from .train import runners

    cfg = _CONFIGS[args.config]()
    if args.lr is not None:
        cfg.train.learning_rate = args.lr
    if args.bf16 is not None:
        cfg.train.bf16 = args.bf16
    common = dict(steps=args.steps, log=args.log, device=args.device)
    if args.config == "nbody":
        res = runners.run_nbody(cfg, graphs=args.graphs, ckpt_dir=args.ckpt_dir,
                                resume=args.resume, **common)
    elif args.config == "qm9":
        res = runners.run_qm9(cfg, molecules=args.molecules, batch_size=args.batch_size,
                              ckpt_dir=args.ckpt_dir, **common)
    else:
        points = args.points or _CLOUD_POINTS[args.config]
        res = runners.run_pointcloud(cfg, points=points, **common)
    print(json.dumps({"config": args.config, **res}))
    return 0


def _cmd_qm9_eval(args) -> int:
    from .train import runners

    res = runners.run_qm9_protocol(
        args.data_dir, target=args.target, steps=args.steps, epochs=args.epochs,
        molecules=args.molecules, batch_size=args.batch_size, seed=args.seed, log=args.log,
        ckpt_dir=args.ckpt_dir, device=args.device)
    print(json.dumps({"protocol": "qm9", **res}))
    return 0


def _cmd_info(_args) -> int:
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(json.dumps({
        "version": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_count": n,
        "devices": [torch.cuda.get_device_name(i) for i in range(n)],
    }))
    return 0


def _cmd_configs(_args) -> int:
    for name, fn in _CONFIGS.items():
        print(f"{name}: {json.dumps(dataclasses.asdict(fn()))}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="scalable_e3_gnn_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    device_help = "torch device to run on (default: the current GPU; 'cpu' for the CPU)"

    t = sub.add_parser("train", help="train an evaluation-ladder config")
    t.add_argument("--config", choices=sorted(_CONFIGS), required=True)
    t.add_argument("--steps", type=int, default=None)
    t.add_argument("--lr", type=float, default=None)
    t.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=None)
    t.add_argument("--graphs", type=int, default=256, help="nbody: #trajectories")
    t.add_argument("--molecules", type=int, default=512, help="qm9: #molecules")
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--points", type=int, default=None, help="cloud: #points")
    t.add_argument("--ckpt-dir", type=str, default=None)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--log", type=str, default=None, help="metrics JSONL path")
    t.add_argument("--device", type=str, default=None, help=device_help)
    t.set_defaults(fn=_cmd_train)

    q = sub.add_parser(
        "qm9-eval",
        help="literature-protocol QM9 eval: 110k/10k/rest split, train-split "
        "z-scoring, per-property MAE in the reported unit (meV for energies)",
    )
    q.add_argument("--data-dir", required=True,
                   help="directory of dsgdb9nsd *.xyz files (+ optional uncharacterized.txt)")
    q.add_argument("--target", default="U0",
                   help="QM9 property (U0, U, H, G, homo, lumo, gap, mu, alpha, r2, zpve, Cv, "
                   "A, B, C)")
    q.add_argument("--steps", type=int, default=None)
    q.add_argument("--epochs", type=int, default=None)
    q.add_argument("--molecules", type=int, default=None,
                   help="cap loaded molecules (CI/smoke)")
    q.add_argument("--batch-size", type=int, default=None)
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--ckpt-dir", type=str, default=None)
    q.add_argument("--log", type=str, default=None)
    q.add_argument("--device", type=str, default=None, help=device_help)
    q.set_defaults(fn=_cmd_qm9_eval)

    i = sub.add_parser("info", help="device/platform report")
    i.set_defaults(fn=_cmd_info)

    c = sub.add_parser("configs", help="list evaluation-ladder configs")
    c.set_defaults(fn=_cmd_configs)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if hasattr(args, "device"):
        from .utils.device import resolve_device

        try:
            resolve_device(args.device)
        except RuntimeError as e:  # no GPU and no --device
            print(f"scalable_e3_gnn_torch: {e}", file=sys.stderr)
            return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
