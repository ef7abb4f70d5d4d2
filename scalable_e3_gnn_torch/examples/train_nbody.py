"""Train SEGNN on the charged N-body task (evaluation config 1).

    python -m scalable_e3_gnn_torch.examples.train_nbody --steps 500
    python -m scalable_e3_gnn_torch.examples.train_nbody --steps 12 --device cpu

The full pipeline: dataset generation, batching, the train step, metrics
logging, checkpoint/resume, and a held-out evaluation.  Runs on the GPU
unless ``--device`` names another device.
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--graphs", type=int, default=256)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--log", type=str, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the current GPU)")
    args = ap.parse_args(argv)

    import torch

    from ..train.checkpoint import restore_checkpoint, save_checkpoint
    from ..train.metrics import MetricsLogger
    from ..train.pipeline import make_train_state, make_train_step, mse_loss
    from ..train.runners import _model, _nbody_batch
    from ..utils.config import nbody_config
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = nbody_config()
    graph, vel, target = _nbody_batch(args.graphs, cfg.train.seed, dev)
    model = _model(cfg, dev)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(model, lambda m, g, v, t: mse_loss(m(g, v), t), opt)
    state = make_train_state(model, opt)
    start = 0
    if args.resume and args.ckpt_dir:
        try:
            state, start = restore_checkpoint(args.ckpt_dir, state)
            print(f"resumed from step {start}")
        except FileNotFoundError:
            pass

    logger = MetricsLogger(args.log, stdout_every=50)
    n_edges = int(graph.edge_mask.sum())
    baseline = float(mse_loss(torch.zeros_like(target), target))
    print(f"predict-zero baseline mse: {baseline:.6f}")
    m = {"loss": float("inf")}
    for i in range(start, args.steps):
        m = step(graph, vel, target)
        state.step = i + 1
        logger.log(i, {"loss": m["loss"], "grad_norm": m["grad_norm"]}, edges=n_edges)
        if args.ckpt_dir and (i + 1) % 200 == 0:
            save_checkpoint(args.ckpt_dir, i + 1, state)
    logger.close()
    print(f"final loss {float(m['loss']):.6f} (baseline {baseline:.6f})")

    # held-out: fresh trajectories, the displacement error
    graph_e, vel_e, target_e = _nbody_batch(max(args.graphs // 5, 16), cfg.train.seed + 1, dev)
    with torch.no_grad():
        err = model(graph_e, vel_e) - target_e
    eval_mse = float(torch.mean(err ** 2))
    disp_rmse = float(torch.sqrt(torch.mean(torch.sum(err ** 2, -1))))
    base_rmse = float(torch.sqrt(torch.mean(torch.sum(target_e ** 2, -1))))
    print(f"eval (held-out): mse {eval_mse:.6f}, displacement rmse {disp_rmse:.6f} "
          f"(predict-zero {base_rmse:.6f})")


if __name__ == "__main__":
    main()
