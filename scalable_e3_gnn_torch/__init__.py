"""PyTorch/CUDA port of ``scalable_e3_gnn_tpu`` for NVIDIA Hopper GPUs.

The same subpackages, module and class names as the JAX package: ``core``
(irreps, Wigner 3j, spherical harmonics, rotations), ``ops`` (the L1 and
generic tensor products, gate, linear and layer norm, the COO and fixed-K
gathers and segment sums), ``graph`` (Morton codes, octree, radius graphs,
the COO container and its batching, the fixed-K container with gather
tables), ``kernels`` (hand-written CUDA kernels with their plain PyTorch
versions), ``models`` (SEGNN), ``data`` (the N-body and QM9 data), ``train``
(loss, train step and state, metrics, checkpoints, the runners of the
evaluation ladder), ``utils`` (device choice, configs, JAX parameters in and
out, profiling hooks), ``parallel`` (the dense partitioner and the
partitioned forward and train step with their halo exchange), ``cli`` (``python
-m scalable_e3_gnn_torch``) and ``examples``.  It imports neither JAX nor the
JAX package.  Entry points run on the GPU unless the caller passes
``device="cpu"``.
"""

from .core.irreps import Instruction, Irrep, Irreps, MulIrrep
from .core.spherical import spherical_harmonics
from .core.wigner import wigner_3j
from .graph.container import DenseEdgeGraph, SteerableGraph
from .graph.octree import Octree, build_octree
from .graph.radius import (radius_graph_brute, radius_graph_cell, radius_graph_cell_segments,
                           suggest_cell_capacity)
from .models.segnn import SEGNN, O3TensorProductGate, SEGNNLayer
from .ops.gate import Gate
from .ops.gather_scatter import scatter_sum, sddmm, segment_mean, segment_sum, spmm
from .ops.linear import O3LayerNorm, O3Linear
from .ops.tensor_product import L1TensorProduct, TensorProduct
from .train.runners import run_nbody, run_pointcloud, run_qm9, run_qm9_protocol
from .utils.params import params_from_jax, params_to_jax

__version__ = "0.1.0"

__all__ = ["Instruction", "Irrep", "Irreps", "MulIrrep", "spherical_harmonics", "wigner_3j",
           "DenseEdgeGraph", "SteerableGraph", "Octree", "build_octree", "radius_graph_brute",
           "radius_graph_cell", "radius_graph_cell_segments", "suggest_cell_capacity", "SEGNN",
           "O3TensorProductGate", "SEGNNLayer", "Gate", "scatter_sum", "sddmm", "segment_mean",
           "segment_sum", "spmm", "O3LayerNorm", "O3Linear", "L1TensorProduct", "TensorProduct",
           "run_nbody", "run_pointcloud", "run_qm9", "run_qm9_protocol", "params_from_jax",
           "params_to_jax", "__version__"]
