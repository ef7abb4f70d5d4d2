"""Experiment configs: plain dataclasses, one per evaluation-ladder entry.

A copy of ``scalable_e3_gnn_tpu/utils/config.py`` (plain Python), kept here so
the port imports nothing of the JAX package.  Config 1 (``nbody_config``) and
config 2 (``qm9_config``) run through ``train.runners``; configs 3-5 are the
point-cloud configs, carried as data.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class ModelConfig:
    input_irreps: str = "2x0e+1x1o"
    hidden_irreps: str = "32x0e+16x1o"
    output_irreps: str = "1x1o"
    lmax_attr: int = 1
    num_layers: int = 4
    task: str = "node"
    vel_attr: bool = False
    remat: bool = False
    layout: Optional[str] = None  # None = auto (cm on the lmax=1 fast path)


@dataclass
class TrainConfig:
    learning_rate: float = 5e-3
    weight_decay: float = 0.0
    num_steps: int = 1000
    batch_size: int = 128
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 500
    log_path: Optional[str] = None
    bf16: bool = False


@dataclass
class GraphConfig:
    radius: float = 0.04
    max_neighbors: int = 24
    bounds: Tuple[float, float] = (0.0, 1.0)
    octree_levels: int = 6
    leaf_size: int = 32
    cell_capacity: int = 0  # 0 = auto: measured max cell occupancy (suggest_cell_capacity)


@dataclass
class ExperimentConfig:
    name: str
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    graph: GraphConfig = field(default_factory=GraphConfig)


def nbody_config() -> ExperimentConfig:
    """Config 1: charged N-body, 5 particles, fully connected, CPU-runnable."""
    return ExperimentConfig(
        name="nbody",
        model=ModelConfig(
            input_irreps="2x0e+1x1o", hidden_irreps="16x0e+8x1o",
            output_irreps="1x1o", num_layers=3, vel_attr=True,
        ),
        train=TrainConfig(learning_rate=5e-3, num_steps=2000, batch_size=256),
    )


def qm9_config() -> ExperimentConfig:
    """Config 2: QM9-style molecular regression, padded batched graphs."""
    return ExperimentConfig(
        name="qm9",
        model=ModelConfig(
            input_irreps="5x0e", hidden_irreps="32x0e+8x1o",
            output_irreps="1x0e", num_layers=4, task="graph",
        ),
        train=TrainConfig(learning_rate=1e-3, num_steps=5000, batch_size=64),
        graph=GraphConfig(radius=2.0, max_neighbors=16),
    )


def cloud100k_config() -> ExperimentConfig:
    """Config 3: 100k-point cloud, radius graph via octree cells, 1 chip."""
    return ExperimentConfig(
        name="cloud100k",
        model=ModelConfig(remat=True),
        train=TrainConfig(learning_rate=1e-3, num_steps=200, bf16=True),
        graph=GraphConfig(radius=0.04, max_neighbors=24, octree_levels=6),
    )


def cloud1m_config() -> ExperimentConfig:
    """Config 4: 1M-point cloud, multi-level octree, lmax=2, edge-partitioned."""
    return ExperimentConfig(
        name="cloud1m",
        model=ModelConfig(
            hidden_irreps="24x0e+12x1o+6x2e", lmax_attr=2, remat=True, layout="cm",
        ),
        train=TrainConfig(learning_rate=1e-3, num_steps=100, bf16=True),
        graph=GraphConfig(radius=0.02, max_neighbors=16, octree_levels=7),
    )


def cloud10m_config() -> ExperimentConfig:
    """Config 5: 10M-point cloud, deep octree, multi-host halo exchange."""
    return ExperimentConfig(
        name="cloud10m",
        model=ModelConfig(remat=True),
        train=TrainConfig(learning_rate=1e-3, num_steps=50, bf16=True),
        graph=GraphConfig(radius=0.01, max_neighbors=16, octree_levels=8),
    )
