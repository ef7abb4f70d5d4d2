"""PyTorch/CUDA port of ``scalable_e3_gnn_tpu`` for NVIDIA Hopper GPUs.

The same subpackages, module and class names as the JAX package: ``core``
(irreps, Wigner 3j, spherical harmonics), ``ops`` (the L1 and generic tensor
products, gate, linear), ``graph`` (Morton codes, octree, radius graphs, the
fixed-K container with gather tables), ``kernels`` (hand-written CUDA kernels with their plain
PyTorch versions), ``models`` (SEGNN), ``train`` (loss and train step) and
``utils`` (device choice, JAX parameters in and out) and ``parallel`` (the
dense partitioner and the partitioned forward and train step with their halo
exchange).  It imports neither
JAX nor the JAX package.  Entry points run on the GPU unless the caller
passes ``device="cpu"``.
"""

from .core.irreps import Irrep, Irreps, MulIrrep
from .core.spherical import spherical_harmonics
from .core.wigner import wigner_3j
from .graph.container import DenseEdgeGraph
from .graph.octree import build_octree
from .graph.radius import (radius_graph_brute, radius_graph_cell, radius_graph_cell_segments,
                           suggest_cell_capacity)
from .models.segnn import SEGNN
from .ops.tensor_product import TensorProduct
from .utils.params import params_from_jax, params_to_jax

__all__ = ["Irrep", "Irreps", "MulIrrep", "spherical_harmonics", "wigner_3j",
           "DenseEdgeGraph", "build_octree", "radius_graph_brute", "radius_graph_cell",
           "radius_graph_cell_segments",
           "suggest_cell_capacity", "SEGNN", "TensorProduct", "params_from_jax",
           "params_to_jax"]
