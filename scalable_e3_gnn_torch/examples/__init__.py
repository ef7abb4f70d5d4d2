"""Runnable examples: ``python -m scalable_e3_gnn_torch.examples.<name>``.

``train_nbody`` (evaluation config 1) and ``train_pointcloud`` (configs 3-4),
the PyTorch counterparts of the JAX package's ``examples/*.py``.
"""
