#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device     -- require CUDA; print the card's name and power limit
                 (``nvidia-smi --query-gpu=name,power.limit``); TF32 off.
2. build      -- compile every CUDA source of the package with nvcc, all at once.
3. graph      -- the config-3 main path up to the model: 100k uniform points,
                 octree (6 levels), radius graph (r=0.04, K=24), symmetrized,
                 gather tables (tile 160), sh attributes; timed; checked
                 against the brute-force radius graph on the same card.
4. kernel     -- the forward kernel's wrapper against its plain PyTorch
                 version on the card, at the main path's shapes, in fp32 and
                 bf16, with a partial tail tile and extra masked slots; in
                 bf16 also a reading of the bf16 ulps (max, share over 1).
5. kernel_bwd -- the backward kernels (main kernel and the weight-gradient
                 reduction) and the full backward with its epilogue against
                 their plain versions on the same inputs and a random
                 cotangent, in fp32 and bf16; two runs bit-identical; the
                 bf16 ulps of every output (a reading).
6. forward    -- the config-3 SEGNN forward (4 layers, bf16 storage, weights
                 from a seed) with launch counts zeroed before and read after;
                 output finite and of shape [100000, 3]; held against the
                 plain path in fp32 on the card.
7. train      -- the config-3 train step (fp32 master weights, bf16 compute,
                 MSE against a seeded target, Adam 1e-3), 5 steps with launch
                 counts zeroed before and read after: every loss and gradient
                 norm finite, exactly 4 forward and 4 backward launches per step.
8. grad_check -- fp32 gradients of every parameter through the kernels
                 against PyTorch autograd through the plain message path, from
                 the same weights and graph, on a 20k-point cloud of the same
                 density (the plain path's autograd at 100k would need tens of GB).
9. times      -- CUDA-event times of the forward, the forward kernel and its
                 plain version, and the graph build.
10. train_times -- CUDA-event times of the train step, the backward kernel,
                 its plain version and the epilogue, with the bounds.
10b. kernel_reduce -- the weight-gradient reduction at its shapes on the
                 main paths (config 3's #2 partials as its grid leaves them,
                 their first 132 rows (one block an SM), #12's and #14's at
                 250k) bitwise against the in-order fold and against
                 ``torch.sum``; device times of both, event times, bounds.
11. profile   -- two train steps traced with ``torch.profiler``: device time
                 per kernel and the device's busy share of the wall time.
12. graph_lmax2 -- the lmax=2 config-4 proxy of bench.py:223-259: 250k uniform
                 points, octree (7 levels), radius graph (r = 0.04 *
                 (100000/250000)^(1/3), K=16, cell capacity 64), symmetrized,
                 gather tables at the generic tile (200); timed.
13. kernel_lmax2 -- the generic kernel (#8) against its plain version on the
                 card at that path's shapes (real tables, geometry and folded
                 layer-0 weights, random features, a masked tail and extra
                 masked slots), in fp32 and in bf16 (elementwise in bf16 ulps:
                 both round at the same points).
14. forward_lmax2 -- the lmax=2 SEGNN forward (24x0e+12x1o+6x2e, 4 layers, bf16,
                 geo-only attributes as bench.py passes them) with launch
                 counts zeroed before and read after: exactly 4 launches of
                 #8; output finite, [250000, 3]; the fp32 kernel path and the
                 bf16 forward held against the fp32 plain path.
15. times_lmax2 -- CUDA-event times of that forward, of #8 (bf16 and fp32) and
                 its plain version, with #8's bound.
16. kernel_bwd_lmax2 -- on phase 13's inputs and a random cotangent, in fp32
                 and bf16 (elementwise in bf16 ulps): #8's save mode, #9
                 (residual) and #10 (replay) with the weight-gradient kernel,
                 the table sum and the reduction against the plain backward
                 with and without the saved ys, each piece against its own
                 plain version, the full backward with its epilogue, #9 against
                 #10, two runs bit-identical.
17. train_lmax2 -- bench.py's 250k bf16 train step (remat, fp32 masters, MSE,
                 Adam 1e-3, geo-only attributes), 3 steps with launch counts per
                 step: 4 of #8, 4 of #9 and its pieces, none of #10; peak memory.
18. graph_1m, train_1m, kernel_bwd_1m -- bench.py's 1M remat_kernel step: the
                 1M graph, then 2 steps: 4 of #8, 4 of #10, none of #9 per
                 step; peak memory; then #8 and #10 (with its pieces and the
                 epilogue) against their plain versions at the 1M shapes, bf16
                 elementwise in ulps, and #10's whole time there.
19. grad_check_lmax2 -- fp32 gradients through #9 and through #10 against
                 autograd through the plain path, 20k points at the 250k density.
20. train_times_lmax2 -- step times at 250k and 1M, #9/#10 whole and their
                 pieces per launch, their plain versions, the reduction, the
                 epilogue, the bounds, and a torch.profiler trace of two 250k
                 steps.

21. train_untabled_250k -- the 250k step of phase 17 on the graph without its
                 gather tables (the runner's path below 500k points): per step
                 4 of #11 (save mode) and 4 of #12, none of #8/#9/#10/#13.
22. train_sym_1m -- the 1M step of phase 18 without tables (500k-2M points):
                 the sym-regather entry, per step 4 of #11 and 4 of #13.
23. kernel_untabled (1M, 250k), untabled_times -- #11 with and without save,
                 #12 and #13 whole against their plain versions in bf16 at
                 both paths' shapes (a d_hs element over the ulp limit passes
                 only with its slot row explained: the plain last stage fed
                 the kernel's own dy_1 gives the kernel's row), #12 = #13
                 bitwise, reruns bit-identical; #12's times at 250k, the step
                 times.
24. graph_10m  -- config 5 (bench_scaling.py:113-240): 10M uniform points, the
                 octree, radius_graph_cell_segments (10 segments, exact "sort"
                 selection: the port's cell graph), not symmetrized, chunked
                 bf16 attributes; times.
25. kernel_untabled (config5_block) -- #11-#13 against their plain versions at
                 one 400k-node block's shapes, fp32 and bf16; times and bounds,
                 device times per launch of #11, the chains, the weight
                 gradients and the reduction.
26. train_config5, config5 -- the 10M train step (edge_chunks=25, remat,
                 remat_kernel, remat_layers=2), a warm-up and a timed step:
                 per step 300 of #11, 100 of #13 (derived in
                 ``config5_phases``); peak memory, loss.
27. grad_check_config5 -- fp32 gradients of the chunked model (4 blocks,
                 remat_layers=2) against the plain path at 20k points of the
                 10M density.
28. kernel_km  -- the untabled lmax=1 kernels #3 and #5 (with the reduction)
                 against their plain versions at the 100k shapes (tile 160)
                 and at one padded 1M block (tile 64), fp32 and bf16
                 (elementwise in bf16 ulps); reruns bit-identical.
29. forward_km -- the config-3 forward on the 100k graph without its tables
                 (take_dense_symmetric_km): exactly 4 launches of #3.
30. train_km_100k -- 5 counted steps there: 4 of #3 and 4 of #5 per step,
                 none of #1/#2.
31. train_km_example_100k -- examples/train_pointcloud.py at its defaults
                 (100k points, not symmetrized, gather_km, remat): 3 steps,
                 then a profile of two (device time per kernel, busy share).
32. train_km_1m -- the example at 1M points (edge_chunks=8, 125,000-node
                 blocks padded to 125,056): per step 64 of #3 and 32 of #5
                 (derived in ``km_phases``); peak memory; a profile of one step.
33. grad_check_km, km_times -- fp32 gradients through #3/#5 against the
                 plain path at 20k points, symmetrized and with edge_chunks=4;
                 the kernels' times, bounds and the untabled step times.
34. kernel_flat -- the packed lmax=1 kernels #6 and #7 (with the reduction)
                 against their plain versions at the 100k shapes (tile 160)
                 at pack 2 and 4, fp32 and bf16, and at 99,990 receivers
                 padded to the km tile; reruns bit-identical.
35. forward_pack -- the config-3 forward at pack 2 on the 100k graph without
                 its tables (take_dense_symmetric): exactly 4 launches of #6.
36. train_pack_100k -- 5 counted steps at each of pack 2, 3, 4
                 (tools/exp_pack.py's A/B): 4 of #6 and 4 of #7 per step,
                 none of #1/#2/#3/#5; step times beside the pack-1 step.
37. grad_check_pack, pack_times -- fp32 gradients through #6/#7 at 20k
                 points against the plain path and against pack 1 (#3/#5),
                 symmetrized and with edge_chunks=4; the kernels' times,
                 bounds and the step times.
38. graph_vjp, train_vjp_250k -- tools/exp_residual_bwd.py's A/B of the
                 three generic backwards on its 250k graph (no tables, bf16,
                 remat; run after phase 23): replay_bwd=False (4 of #11 and 4
                 of #14 per step, #14's weight-gradient kernel and the
                 reduction once per group of backward tiles), #13 and #12.
39. kernel_vjp -- #14 against its plain version there in fp32 and bf16 at
                 backward tiles 200 and 80; reruns bit-identical; times.
40. train_vjp_1m -- the 1M remat_kernel step with replay_bwd=False (no
                 tables): 8 of #11 (the checkpoint replays it), 4 of #14 at
                 backward tile 80 per step.
41. grad_check_vjp -- fp32 gradients through #14 at 20k points against the
                 plain path and against #13.
42. forward_sparse, train_sparse -- the lmax_attr=5 model (non-foldable
                 message layers, A=36) on the 250k graph: a counted forward
                 (4 of #11) and 3 counted steps (4 of #11, 4 of #14); peak
                 memory.
43. kernel_sparse, grad_check_sparse, vjp_times -- #11 and #14 at A=36
                 against their plain versions (bf16), fp32 gradients of the
                 lmax_attr=5 model at 20k points against the plain path; the
                 times.
44. dist_partition -- the dense partitioner on config 3's 100k graph at P = 1
                 and 4: host ms, NI/NB/H, both transpose tables' q; every
                 valid edge of the input found once over the partitions.
45. kernel_ring -- the halo ring #15 against its plain version at P = 1, 2,
                 4, 8 (odd H and F) and at config 3's P=4 [H, 80] in bf16 and
                 fp32, bitwise; device times (torch.profiler) of the kernel,
                 its plain version and the library call, and its bound.
46. dist_forward -- config 3's bf16 forward partitioned (all P partitions on
                 the card) at P=1 (all_gather) and P=4 (all_gather, ring):
                 against the unpartitioned fp32 plain path, bit for bit the
                 unpartitioned bf16 kernel forward, ring = all_gather
                 bitwise, launches of #3 (2 blocks x P x 4 layers) and #15 (4).
47. dist_train -- bench_scaling.py's measure: 5 timed bf16 steps after a
                 warm-up at P=1 and at P=4 with each backend, launches per
                 step, peak memory, the single-card untabled step beside, a
                 profile of two steps at each P and backend.
48. dist_grad_check -- fp32 gradients of the P=4 partitioned step (both
                 backends) against the unpartitioned plain path at 20k points.
49. dist_lmax2 -- the 250k lmax=2 model at P=4 (ring): a counted forward
                 (#11 per block) against the unpartitioned fp32 plain path and
                 bit for bit the unpartitioned bf16 kernel forward, and 2
                 counted train steps (#11, #12).
49b. dist_procs -- the P=4 config-3 train step as two processes on the one
                 card (torch.distributed, gloo, two partitions each; the
                 workers of ``parallel.dense_worker`` under the Supervisor):
                 each rank's bf16 forward bit for bit the one-process P=4
                 forward, a warm-up and 5 timed steps with a heartbeat and
                 per-rank checkpoints, the same losses on both ranks within
                 3e-4 of the one-process curve, parameters equal across the
                 ranks, per rank and step 16 of #3, #5 and the reduction;
                 then rank 1 killed after step 3's checkpoint: one restart,
                 the final parameters bit for bit the fault-free run's;
                 step ms per rank, collective host ms, detection to resume.
49c. coo_dist  -- config 3 as a COO graph (the 100k cell radius graph, K=24,
                 not symmetrized; fp32, plain PyTorch) partitioned by
                 ``partition_graph`` at P=4: every valid edge in one partition;
                 the forward with each backend within 2e-5 max(1, max|ref|) of
                 the unpartitioned COO forward, ring = all_gather bitwise, 4 of
                 #15 per forward under ring, nothing else; 3 ring steps (Adam
                 1e-3), the first's gradients within 5e-5 max|ref| and loss
                 within 1e-6 of autograd on the unpartitioned model, 4 of #15 a
                 step; then a dp x graph step of two clouds (seeds 0, 1) under
                 shared tight caps, its loss the mean of the two clouds' MSEs
                 within 1e-5; the steps at the largest halving of the points
                 that fits the card (the cut printed); forward and step ms,
                 peak memory, #15's device ms at this path's fp32 shape.
49d. dp_dense  -- the dense path on two config-3 clouds (seeds 0, 1) x P=4
                 (bf16 on fp32 masters, Adam 1e-3, #3/#5): in one process the
                 forward and 5 timed steps after a warm-up, 64 each of #3, #5
                 and the reduction a step; then 4 processes on the card (2 dp
                 rows x 2 graph ranks): each rank's forward bit for bit the
                 one-process one, the same losses on every rank within 3e-4 of
                 the one-process curve, parameters and Adam states equal, 16
                 each of #3, #5 and the reduction per rank and step.
49e. overlap   -- that 4-process world again with the exchange serialized:
                 forward, losses and final parameters bit for bit the
                 overlapped run's; step ms per rank and host ms in collectives
                 per step both ways.
49f. ring_procs -- kernel #15 between processes on the card (``IpcRing``:
                 publish and gather kernels over CUDA IPC): a 2-process stress
                 world (200 exchanges of config 3's [2, H, 80] in bf16 and fp32
                 and of odd [2, 37, 13], every pool bit for bit gloo's
                 all-gather; a skipped publish raising on every rank within
                 its bound); dist_procs's world under ring (forwards bit for
                 bit the one-process one, losses and final parameters bit for
                 bit the all_gather world's, 4 publishes and 4 gathers per
                 rank and step beside 16 of #3, #5 and the reduction, the
                 restart after a kill bit for bit); dp_dense's 4-process world
                 under ring (bit for bit its all_gather world); the COO P=4
                 graph as 2 processes under ring (forward bit for bit the
                 one-process all_gather forward); step ms, gloo host ms, the
                 kernels' device ms and bounds.
50. coo_nbody, coo_qm9 -- configs 1 and 2 of the evaluation ladder on the COO
                 path (no hand kernel: every count must stay 0), through
                 ``train.runners``: ``run_nbody`` (256 graphs) and ``run_qm9``
                 (512 molecules, batches of 64) for 25 fp32 steps and their
                 held-out evaluation on the card; again, bit for bit; the
                 first 5 steps on the CPU from the same seed (the same
                 weights), each loss within 1e-5 relative of the card's; a
                 resume on the card (2N steps = N, a checkpoint, restored, N)
                 bit for bit; CUDA-event times of 20 steps after a warm-up,
                 the host time per step with and without the metrics
                 logger's per-step reads, the evaluation's time, a profile of
                 one step (launches, device busy share).
51. coo_gates  -- the accuracy gates of tests/test_accuracy_gate.py on the card
                 (N-body: 400 steps on 64 graphs, train loss < 0.009, held-out
                 MSE < 0.011 and < 0.2x predict-zero; QM9 stand-in: 250 steps
                 on 48 molecules, loss < 0.16) from JAX's initial weights
                 (tests/fixtures/gate_init.npz), checked; and from the port's
                 own seeded weights (seeds 0 and 1, as the JAX test's keys),
                 read only: at seed 0 the N-body held-out MSE misses 0.011 on
                 the CPU too (ROADMAP.md section 3).

24b. graph_10m_approx2 -- bench.py:111-126's approx2 build of the 10M graph
                 (10 segments, recall 0.85) beside the exact one: times, its
                 recall of the exact edges (>= 0.85), every edge <= 1.02 r.
24c. partition_10m -- bench.py:128-140's partition_s_10m_p16: the host
                 partitioner (native helpers) at P=16 on that graph.
52. cli_cloud100k -- ``python -m scalable_e3_gnn_torch train --config
                 cloud100k --steps 5`` in this process (``cli.main``): the
                 runner at full size on the card, counts zeroed just before
                 and read just after; per step 4 of #3, 4 of #5; the
                 held-out forward 4 of #3; losses finite and falling; step
                 ms, graph build ms, peak memory, eval_mse.
53. cli_cloud1m -- ``train --config cloud1m --steps 3``: the sym-regather
                 entry, per step 4 of #11 and 4 of #13.
54. cli_cloud10m, kernel_km_10m -- ``train --config cloud10m --steps 3`` at
                 10M points (the "approx" segmented build, 25 node blocks,
                 remat_kernel, remat_layers=2): per step 300 of #3, 100 of
                 #5, the last step profiled; then #3/#5 against their plain
                 versions at its first 400k-node block in bf16.
55. cli_coo    -- ``train --config nbody`` and ``--config qm9``, 3 steps each:
                 no hand kernel.
56. cli_qm9_eval -- ``qm9-eval`` on 40 synthetic .xyz files: no hand kernel,
                 MAEs in meV.

Then the ``kernels`` line, the card line and, last, the result line.  Any
failed check raises: the script exits non-zero and prints no result.  It
exits non-zero as well without a GPU or without the package beside it.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import itertools
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import scalable_e3_gnn_torch as port
from scalable_e3_gnn_torch.graph.radius import radius_graph_brute, search_level_for_radius
from scalable_e3_gnn_torch.kernels import fused_message as fm
from scalable_e3_gnn_torch.kernels import fused_message_generic as fmg
from scalable_e3_gnn_torch.kernels import halo_ring as hr
from scalable_e3_gnn_torch.kernels.build import build_libraries
from scalable_e3_gnn_torch.models.segnn import SEGNNLayer
from scalable_e3_gnn_torch.ops.gather_scatter import gather_km
from scalable_e3_gnn_torch.data import native_loader
from scalable_e3_gnn_torch.parallel import dense_worker
from scalable_e3_gnn_torch.parallel import halo as dist
from scalable_e3_gnn_torch.parallel import ring_stress
from scalable_e3_gnn_torch.parallel.partition import (partition_graph, partition_graph_dense,
                                                      shared_caps)
from scalable_e3_gnn_torch.train.pipeline import make_train_step, mse_loss

# config 3 (bench.py of the JAX package)
N_POINTS = 100_000
RADIUS = 0.04
MAX_NEIGHBORS = 24
LO, HI = (0.0,) * 3, (1.0,) * 3
HIDDEN = "32x0e+16x1o"
NUM_LAYERS = 4
TILE = 160
OCTREE_LEVELS = 6
SEED = 0
DEVICE = "cuda"
TRAIN_STEPS = 5
LEARNING_RATE = 1e-3  # optax.adam(1e-3) of bench.py
# the gradient check's cloud: 5x fewer points in the same cube, the radius
# grown by 5^(1/3) so the neighbourhoods stay as full as at 100k
GC_POINTS = 20_000
GC_RADIUS = RADIUS * 5 ** (1 / 3)
# the lmax=2 config-4 proxy (bench.py:223-259): not cut
L2_POINTS = 250_000
L2_RADIUS = RADIUS * (N_POINTS / L2_POINTS) ** (1 / 3)
L2_NEIGHBORS = 16
L2_CELL_CAPACITY = 64
L2_OCTREE_LEVELS = 7
L2_HIDDEN = "24x0e+12x1o+6x2e"
L2_TRAIN_STEPS = 3  # bench.py times 3 steps at 250k ...
L1M_TRAIN_STEPS = 2  # ... and 2 at 1M
# the 1M remat_kernel config (bench.py:261-299): not cut
L1M_POINTS = 1_000_000
L1M_RADIUS = RADIUS * (N_POINTS / L1M_POINTS) ** (1 / 3)
# the lmax=2 gradient check's cloud: the 250k cloud's density at 20k points
GC2_POINTS = 20_000
GC2_RADIUS = L2_RADIUS * (L2_POINTS / GC2_POINTS) ** (1 / 3)
# config 5 (bench_scaling.py:113-240, config5_single_chip): not cut; the one
# deviation is the exact "sort" neighbour selection where the bench takes
# lax.approx_min_k ("approx", a TPU primitive)
C5_POINTS = 10_000_000
C5_RADIUS = RADIUS * (N_POINTS / C5_POINTS) ** (1 / 3)
C5_SEGMENTS = 10  # radius_graph_cell_segments(num_segments=points // 1M)
C5_CHUNKS = 25  # bench_scaling.py --chunks default: 400k-node blocks
C5_REMAT_LAYERS = 2
C5_TRAIN_STEPS = 2  # one warm-up step, one timed
# its gradient check's cloud: 20k points at the 10M density, 4 node blocks
GC5_POINTS = 20_000
GC5_RADIUS = C5_RADIUS * (C5_POINTS / GC5_POINTS) ** (1 / 3)
GC5_CHUNKS = 4
# examples/train_pointcloud.py (the untabled lmax=1 path): r = 0.04 (1e5 /
# n)^(1/3) and edge_chunks = max(1, n // 125,000); run at its default 100k
# points and at --points 1000000 (L1M_POINTS): not cut
EX_POINTS = 100_000
EX_BLOCK = 125_000

# H100 SXM published peaks (NVIDIA data sheet), for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FMA_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# tolerances, each with its reason
TOL_KERNEL_FP32 = 1e-4  # x max(1, |ref|): the same fp32 math summed in another order
TOL_KERNEL_BF16 = 3e-2  # x max|ref|: bf16 rounding of layer-1 outputs and slot messages
# kernel #8 vs its plain version, both bf16 with the same rounding points:
# elementwise in bf16 ulps of max(|ref|, mean|ref|); they differ only where an
# fp32 sum in another order lands on the other side of a bf16 rounding step
TOL_GENERIC_BF16_ULPS = 4
TOL_GENERIC_BF16_OVER_1ULP = 1e-3  # share of elements more than 1 ulp apart
TOL_BWD_FP32 = 1e-4  # d_h: x max(1, |ref|); weight blocks: x max|ref| (sums over 2.4M slots)
# the lmax=2 backward kernels vs their plain versions in bf16, both rounding
# at the same points: elementwise in bf16 ulps of max(|ref|, mean|ref|); the
# 250k readings were at most 5 ulps and 3.4e-5 of the elements over 1 ulp
TOL_GENERIC_BWD_BF16_ULPS = 8
TOL_GENERIC_BWD_BF16_OVER_1ULP = 1e-3  # share of elements more than 1 ulp apart
# the untabled lmax=1 backward's d_hs (#5) is held to the same limits, but
# against the plain backward with exact (fp64) sums between the same
# roundings: at the 10M-point block (512M elements) the plain version itself
# lies 8.19 ulps from that reference, so no kernel could hold 8 ulps against
# the plain version there; the limit is the larger of 8 and the plain
# version's own distance (km_d_hs_check)
# the untabled kernels (#11-#13) are held to the same limits.  A d_hs element
# over them passes only where its slot row is explained: the plain last stage
# (dm_0 from dy_1), fed the kernel's own dy_1 of that row, gives the kernel's
# d_hs row within TOL_FLIP_REFED_ULPS; the excess then comes from dy_1, which
# the kernel rounded on the other side of a bf16 step than the plain version
# (an fp32 sum upstream in another order), and the last stage is exact
TOL_FLIP_REFED_ULPS = 1  # one rounding step of the output itself
TOL_BWD_BF16 = 5e-2  # x max|ref|: bf16 rounding of the cotangent intermediates
TOL_REDUCE = 1e-5  # x max|ref|: fp32 sums over the blocks in another order
TOL_REDUCE_LIB = 1e-6  # x max(1, max|ref|): the same sums, torch.sum's order against the rows'
TOL_FORWARD_FP32 = 1e-4  # x max(1, |ref|): kernel vs plain path, both fp32, 4 layers
TOL_FORWARD_BF16 = 5e-2  # x max|ref|: bf16 storage through 4 layers vs fp32 plain path
TOL_GRAD_FP32 = 1e-4  # x max|ref| per parameter: fp32 sums in another order, 4 layers
# x max(1, |ref|) elementwise: the packed model against itself at pack 1 (#3/#5), both
# fp32 (the JAX package's pack test holds them within 2e-6)
TOL_PACK_VS_KM = 1e-5
TOL_RADIUS_AGREE = 0.9999  # share of identical (receiver, sender) pairs; d^2 rounding at r

TPU_FILE = "scalable_e3_gnn_tpu/kernels/fused_message.py"
GENERIC_TPU_FILE = "scalable_e3_gnn_tpu/kernels/fused_message_generic.py"
ALL_KERNELS = fm.KERNELS + fmg.KERNELS + hr.KERNELS


_T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line of a phase, with ``t_s``: seconds since the script began."""
    print(json.dumps({"phase": phase, "t_s": round(time.perf_counter() - _T0, 3), **kw}),
          flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def event_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_graph(pts, radius=None, levels=None, k=None, cap=None, tile=None, tables=True):
    """The config-3 graph of ``pts`` on the card (radius, octree levels, K,
    cell capacity and table tile as given, config 3's otherwise); returns
    (tree, cell capacity, raw edges, graph with tables (without them when
    ``tables`` is False), timings)."""
    radius = RADIUS if radius is None else radius
    dev = torch.device(DEVICE)
    times = {}
    tree, times["octree_ms"] = sync_time(
        lambda: port.build_octree(pts, LO, HI, num_levels=levels or OCTREE_LEVELS, device=dev))
    cap = cap or port.suggest_cell_capacity(tree, radius, LO, HI)
    edges, times["radius_graph_ms"] = sync_time(
        lambda: port.radius_graph_cell(tree, radius, LO, HI, max_neighbors=k or MAX_NEIGHBORS,
                                       cell_capacity=cap))
    feats = np.random.default_rng(SEED + 1).standard_normal((len(pts), 5)).astype(np.float32)
    graph, times["symmetrize_ms"] = sync_time(
        lambda: port.DenseEdgeGraph.from_radius_edges(feats, tree.points, edges,
                                                      symmetrize=True))
    if not tables:
        return tree, cap, edges, graph, times
    graph_t, times["tables_ms"] = sync_time(lambda: graph.with_gather_tables(tile=tile or TILE))
    return tree, cap, edges, graph_t, times


def edge_agreement(a, b, n):
    """|A & B| / |A | B| over the valid (receiver, sender) pairs of two edge lists."""
    ka = (a.receivers.long() * n + a.senders.long())[a.mask]
    kb = (b.receivers.long() * n + b.senders.long())[b.mask]
    both = torch.isin(ka, kb).sum().item()
    return both / max(ka.numel() + kb.numel() - both, 1)


def messages_per_slot(cfg) -> int:
    """Multiply-adds of the two message layers for one slot."""
    s1, v1, hs, hv = cfg.s1, cfg.v1, cfg.hs, cfg.hv
    c0 = hs + hv
    return ((s1 + v1) * c0 + s1 * hv + 3 * v1 * hv) + (c0 * c0 + hs * hv + 3 * hv * hv)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops, peak_flops=PEAK_BF16_FLOPS):
    """(bound ms, 'bytes' or 'operations', bytes ms, operations ms)."""
    b_ms, o_ms = n_bytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms > o_ms else "operations"), b_ms, o_ms


def kernel_inputs(graph, attrs, layer, dtype, gen):
    """The tabled kernel's arguments at the main path's shapes: the real
    tables, geometry and (folded) weights of a layer, random features, a partial tail tile
    (the last 37 receivers padded the way the model pads) and extra masked
    slots."""
    edge_attr, _, dist2 = attrs[:3]
    n, k = graph.edge_mask.shape
    npad = graph.gather_loc.shape[0]
    cfg = fm.MessageConfig(hs=layer._pallas_hs, hv=layer._pallas_hv, k=k, tile=graph.gather_tile,
                           u=graph.gather_tab.shape[1])
    dev = graph.device
    mask = graph.edge_mask & (torch.rand((n, k), generator=gen, device=dev) > 0.1)
    cut = 37
    mask[n - cut:] = False
    loc = graph.gather_loc.clone()
    loc[n - cut:] = cfg.u
    h = torch.randn((npad, cfg.f), generator=gen, device=dev)
    h[n - cut:] = 0.0
    pad = lambda x: torch.cat([x, x.new_zeros((npad - n,) + x.shape[1:])])
    args = (h, pad(dist2).reshape(npad * k, 1), pad(edge_attr).reshape(npad * k, 4),
            pad(mask.float()).reshape(npad * k, 1), loc.reshape(npad * k, 1),
            graph.gather_tab)
    args = [a.to(dtype).contiguous() if a.is_floating_point() else a.contiguous() for a in args]
    return cfg, args, layer._folded_weights(dtype), int(mask.sum())


def compare(got, ref, scale, tol):
    """(max abs err, elements over tol * scale, max |ref|) of two tensors."""
    err = (got.float() - ref.float()).abs()
    return float(err.max()), int((err > tol * scale).sum()), float(ref.float().abs().max())


def bf16_ulps(got, ref, floor=None):
    """|got - ref| elementwise in bf16 ulps (8 significant bits) of
    max(|ref|, mean|ref|): the floor keeps elements near zero, which are sums
    of larger slot messages, from counting their own tiny ulps.  ``floor``:
    that mean, when ``ref`` is a part of the tensor it was taken over."""
    r = ref.float().abs()
    floor = float(r.mean()) if floor is None else floor
    scale = torch.clamp(r, min=max(floor, 1e-30))
    return (got.float() - ref.float()).abs() / torch.exp2(torch.floor(torch.log2(scale)) - 7)


def ulps_reading(got, ref) -> dict:
    """A bf16 output's ulps against its plain version (``bf16_ulps``): the
    max and the share of elements over 1 ulp; a reading, not a check."""
    u = bf16_ulps(got, ref)
    return dict(max=float(u.max()), share_over_1ulp=float((u > 1).float().mean()))


def bf16_loss(m, g, a, t):
    """bench.py's loss: the forward under bf16 copies of the fp32 masters, so
    the gradients flow back through the casts to fp32."""
    p = {nm: w.to(torch.bfloat16) for nm, w in m.named_parameters()}
    return mse_loss(torch.func.functional_call(m, p, (g,), {"attrs": a}).float(), t)


def expected(counts: dict) -> dict:
    """Launch counts of every kernel: those given, zero for the rest."""
    return {kern.name: counts.get(kern.name, 0) for kern in ALL_KERNELS}


def nonzero(counts: dict) -> dict:
    """The kernels of ``counts`` launched at least once."""
    return {k: v for k, v in counts.items() if v}


def reset_launches() -> None:
    for kern in ALL_KERNELS:
        kern.launches = 0


def launch_counts() -> dict:
    return {kern.name: kern.launches for kern in ALL_KERNELS}


def profile_steps(step, batch, steps: int = 2, top: int = 14, host_top: int = 0) -> dict:
    """Device time per kernel over ``steps`` train steps (torch.profiler),
    per step, the device's busy share of the wall time and the kernel
    launches per step (every kernel the trace holds); with
    ``host_top``, that many host operators by their own host time per step
    (the CPU-side rows, without their children)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return profile_summary(prof, steps, wall_ms, top, host_top)


def profile_summary(prof, steps: int, wall_ms: float, top: int = 14, host_top: int = 0) -> dict:
    """``profile_steps``'s readings from a finished torch.profiler trace of
    ``steps`` steps that took ``wall_ms``."""
    rows = []
    for ev in prof.key_averages():
        # device-side events only: an operator's row repeats its kernels' time
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            rows.append((ev.self_device_time_total / 1e3 / steps, ev.count / steps, ev.key[:90]))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    out = dict(steps=steps, wall_ms_per_step=wall_ms / steps, device_ms_per_step=busy,
               device_busy_share=busy * steps / wall_ms if wall_ms else 0.0,
               launches_per_step=sum(r[1] for r in rows),
               top=[dict(name=n, ms_per_step=ms, calls_per_step=c) for ms, c, n in rows[:top]])
    if host_top:
        host = sorted(((ev.self_cpu_time_total / 1e3 / steps, ev.count / steps, ev.key[:60])
                       for ev in prof.key_averages()
                       if ev.device_type == torch.autograd.DeviceType.CPU), reverse=True)
        out["host_ms_per_step"] = sum(h[0] for h in host)
        out["host_top"] = [dict(name=n, ms_per_step=ms, calls_per_step=c)
                           for ms, c, n in host[:host_top]]
    return out


def kernel_device_ms(fn, iters: int = 50, warmup: int = 5, one: bool = True) -> tuple:
    """(device ms, traced launches) of the one kernel that each call of
    ``fn`` launches, from a torch.profiler trace of ``iters`` calls: the mean
    over the launches the trace holds (it may hold fewer than ``iters``),
    without the host time between them.  ``one=False`` (a library call): the
    sum of each kernel's mean, and the fewest launches traced of any."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0]
    check(len(evs) == 1 or (not one and evs), f"one kernel per call expected, traced "
          f"{[ev.key for ev in evs]}")
    return (sum(ev.self_device_time_total / 1e3 / ev.count for ev in evs),
            min(ev.count for ev in evs))


def kernels_device_ms(calls, names: dict, rounds: int = 2) -> dict:
    """Device ms per launch of each named kernel from one torch.profiler
    trace of ``rounds`` rounds of ``calls`` (after one untraced round):
    ``names`` maps a label to the substrings its kernel's name holds; a
    label the trace holds no launch of reads None (the profiler may drop
    records)."""
    from torch.profiler import ProfilerActivity, profile

    for fn in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            for fn in calls:
                fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0]
    out = {}
    for label, subs in names.items():
        hits = [ev for ev in evs if all(x in ev.key for x in subs)]
        out[label] = (sum(ev.self_device_time_total for ev in hits) / 1e3
                      / sum(ev.count for ev in hits)) if hits else None
    return out


def reduce_shapes(dev) -> dict:
    """The reduction's partials on the lmax=2 paths at 250k points: #12's
    weight-gradient kernel leaves [_wgrad_splits, NW], #14 folds [1 + a group
    of tiles, NW] (its running sum first)."""
    n, tile = L2_POINTS, SEGNNLayer._pick_generic_tile(L2_POINTS)
    model = lmax2_model(dev)
    kern = fmg.FusedMessageGeneric(model.layers[0].message_layers, L2_NEIGHBORS, tile)
    cfg = kern.config(model.attr_irreps.dim, 0)
    (c1a, da, _), (c1b, db, _) = cfg.widths
    nw = cfg.a * (c1a * da + c1b * db)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ntiles = n // model.layers[0]._pick_bwd_tile(n)
    return {"generic_bwd_res_250k": (fmg._wgrad_splits(cfg, n * L2_NEIGHBORS, sms), nw),
            "generic_bwd_vjp_250k": (1 + fmg.vjp_group(cfg, ntiles), nw)}


def reduce_phase(card: str, partials3) -> list:
    """Phase 10b, kernel_reduce: the fixed-order weight-gradient reduction at
    its shapes on the main paths -- config 3's #2 partials (phase 5's, bf16
    run) and their first 132 rows, #12's and #14's at 250k (random, from a
    seed) -- bitwise
    against the in-order fold on the card (``acc += partials[b]`` in fp32,
    b = 0..n-1) and within TOL_REDUCE_LIB of ``torch.sum``; device times
    (torch.profiler) of the kernel and of ``torch.sum`` (its plain version and
    the library call), CUDA-event times of both, and the bound: the partials
    read once, the sums written once."""
    dev = partials3.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    # #2's partials as its grid leaves them, and their first 132 rows (one
    # block an SM: the [132, 9280] whose times the kernel table keeps)
    cases = [("config3_tab_bwd", partials3),
             ("config3_tab_bwd_132", partials3[:132].contiguous())]
    cases += [(label, torch.randn(shape, generator=gen, device=dev))
              for label, shape in reduce_shapes(dev).items()]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for label, x in cases:
        got = fm.tab_bwd_reduce(x)
        plan = fm.reduce_plan(x.shape[0], x.shape[1], (x.data_ptr(), got.data_ptr()), sms)
        fold = torch.zeros_like(got)
        for row in x:
            fold += row
        lib = fm.tab_bwd_reduce_plain(x)
        scale = max(1.0, float(lib.abs().max()))
        err = float((got - lib).abs().max())
        ms, traced = kernel_device_ms(lambda: fm.tab_bwd_reduce(x))
        lib_ms, lib_traced = kernel_device_ms(lambda: fm.tab_bwd_reduce_plain(x), one=False)
        b_ms, b_by, _, _ = bound(nbytes(x) + 4 * x.shape[1], x.numel(), PEAK_FP32_FMA_FLOPS)
        rows.append(dict(label=label, shape=list(x.shape), mbytes=nbytes(x) / 1e6, plan=plan,
                         bitwise_equal_in_order_fold=bool(torch.equal(got, fold)),
                         max_abs_err_vs_torch_sum=err, max_abs_ref=scale,
                         ms=ms, torch_sum_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         traced_launches_of_50=dict(kernel=traced, torch_sum=lib_traced),
                         event_ms=dict(kernel=event_ms(lambda: fm.tab_bwd_reduce(x), iters=50,
                                                       warmup=5),
                                       torch_sum=event_ms(lambda: fm.tab_bwd_reduce_plain(x),
                                                          iters=50, warmup=5))))
        del got, fold, lib
    emit("kernel_reduce", kernel=fm.TAB_BWD_REDUCE.name, cases=rows, card=card,
         times="device time from torch.profiler; event_ms: CUDA events around 50 calls",
         tolerance=f"bitwise vs the in-order fold; {TOL_REDUCE_LIB} * max(1, max|ref|) vs "
                   "torch.sum (fp32 sums in another order)")
    for r in rows:
        check(r["bitwise_equal_in_order_fold"], f"{r['label']}: the reduction is not the "
              "in-order fold bit for bit")
        check(r["max_abs_err_vs_torch_sum"] <= TOL_REDUCE_LIB * r["max_abs_ref"],
              f"{r['label']}: the reduction vs torch.sum {r['max_abs_err_vs_torch_sum']}")
    return rows


def generic_kernel_inputs(kern, graph, edge_geo, dtype, gen):
    """Kernel #8's arguments at the lmax=2 path's shapes: the real tables,
    geometry and folded (column-permuted) layer-0 weights, random features, a
    masked tail (the last 37 receivers without senders or valid slots) and
    extra masked slots.  Returns (cfg, args, valid slots)."""
    n, k = graph.edge_mask.shape
    dev = graph.device
    a = edge_geo.shape[1] // k - 2
    cfg = kern.config(a, graph.gather_tab.shape[1])
    geo = edge_geo.reshape(n, k, a + 2).clone()
    geo[..., a + 1] *= (torch.rand((n, k), generator=gen, device=dev) > 0.1).to(geo.dtype)
    cut = 37
    geo[n - cut:, :, a + 1] = 0.0
    loc = graph.gather_loc.clone()
    loc[n - cut:] = cfg.u
    h = torch.randn((n, cfg.f), generator=gen, device=dev)
    h[n - cut:] = 0.0
    n_valid = int((geo[..., a + 1] > 0).sum())
    args = (h.to(dtype), geo.reshape(n, -1).to(dtype).contiguous(), loc.contiguous(),
            graph.gather_tab.contiguous(), [w.contiguous() for w in kern.fold(dtype)],
            kern.selections(dev))
    return cfg, args, n_valid


def lmax2_phases(card: str) -> dict:
    """Phases 12-15 (the lmax=2 config-4 proxy); returns kernel #8's numbers
    for the ``kernels`` line."""
    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    # ---- 12. the graph
    pts = np.random.default_rng(SEED + 5).random((L2_POINTS, 3)).astype(np.float32)
    tile = SEGNNLayer._pick_generic_tile(L2_POINTS)
    kw = dict(radius=L2_RADIUS, levels=L2_OCTREE_LEVELS, k=L2_NEIGHBORS,
              cap=L2_CELL_CAPACITY, tile=tile)
    build_graph(pts, **kw)  # warm-up
    _, cap, edges, graph, gtimes = build_graph(pts, **kw)
    emit("graph_lmax2", points=L2_POINTS, radius=L2_RADIUS, k=L2_NEIGHBORS, cell_capacity=cap,
         octree_levels=L2_OCTREE_LEVELS, edges_cell=int(edges.num_edges),
         edges_symmetrized=int(graph.edge_mask.sum()), tile=tile,
         table_size=graph.gather_tab.shape[1], card=card, graph_build_ms=sum(gtimes.values()),
         **gtimes)
    check(graph.gather_loc.shape[0] == L2_POINTS and graph.gather_tile == tile,
          f"tables at tile {graph.gather_tile} for {graph.gather_loc.shape[0]} rows")
    check(int(graph.edge_mask.sum()) > 0, "no edges")
    del edges

    model = port.SEGNN("2x0e+1x1o", L2_HIDDEN, "1x1o", lmax_attr=2, num_layers=NUM_LAYERS,
                       layout="cm", use_pallas=True, device=dev,
                       generator=torch.Generator().manual_seed(SEED))
    check(all(layer.use_pallas_generic and layer._tab_eligible(L2_POINTS, graph)
              for layer in model.layers), "the lmax=2 layers do not take the tabled kernel")
    with torch.no_grad():
        attrs32 = model.compute_attributes_dense(graph)

    # ---- 13. kernel #8 vs its plain version at this path's shapes
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    kern = fmg.FusedMessageGeneric(model.layers[0].message_layers, L2_NEIGHBORS, tile)
    kres = {}
    with torch.no_grad():
        for dtype, tol in ((torch.float32, TOL_KERNEL_FP32), (bf, TOL_KERNEL_BF16)):
            cfg, args, n_valid = generic_kernel_inputs(kern, graph, attrs32[3], dtype, gen)
            got = fmg.generic_tab_fwd(cfg, *args).float()
            torch.cuda.synchronize()
            ref = fmg.generic_tab_fwd_plain(cfg, *args).float()
            err = (got - ref).abs()
            ulps = {}
            if dtype == torch.float32:
                bad = int((err > tol * torch.clamp(ref.abs(), min=1.0)).sum())
                limit = f"{tol} * max(1, |ref|) elementwise; fp32 sums in another order"
            else:
                # the same rounding points: elementwise in bf16 ulps, and the
                # loose whole-tensor limit beside it
                u = bf16_ulps(got, ref)
                ulps = dict(max_ulps=float(u.max()), share_over_1ulp=float((u > 1).float().mean()),
                            share_equal=float((err == 0).float().mean()))
                bad = int((err > tol * ref.abs().max()).sum()) + int(
                    (u > TOL_GENERIC_BF16_ULPS).sum())
                limit = (f"{TOL_GENERIC_BF16_ULPS} bf16 ulps of max(|ref|, mean|ref|) elementwise "
                         f"and at most {TOL_GENERIC_BF16_OVER_1ULP} of the elements over 1 ulp "
                         "(the plain version rounds where the kernel does; fp32 sums in "
                         f"another order flip a rounding now and then); and {tol} * max|ref|")
                if ulps["share_over_1ulp"] > TOL_GENERIC_BF16_OVER_1ULP:
                    bad += 1
            max_err = float(err.max())
            kres[dtype] = dict(cfg=cfg, args=args, n_valid=n_valid, max_abs_err=max_err)
            emit("kernel_lmax2", kernel=fmg.GENERIC_TAB_FWD.name,
                 dtype=str(dtype).replace("torch.", ""), rows=args[0].shape[0], k=cfg.k,
                 tile=cfg.tile, u=cfg.u, a=cfg.a, widths=cfg.widths, valid_slots=n_valid,
                 max_abs_err=max_err, max_rel_err=max_err / max(float(ref.abs().max()), 1e-30),
                 max_abs_ref=float(ref.abs().max()), mean_abs_ref=float(ref.abs().mean()),
                 **ulps, elements_over_tolerance=bad, tolerance=limit,
                 finite=bool(torch.isfinite(got).all()))
            check(bad == 0 and bool(torch.isfinite(got).all()),
                  f"kernel #8 vs plain in {dtype}: {bad} elements over tolerance {ulps}")
        del got, ref, err

    # ---- 14. the bf16 forward through kernel #8, counted (geo-only attributes)
    model_bf = copy.deepcopy(model).to(bf)
    attrs_bf = (None, attrs32[1].to(bf), None, attrs32[3].to(bf))
    graph_bf = graph._replace(nodes=graph.nodes.to(bf))
    fwd = lambda: model_bf(graph_bf, attrs=attrs_bf)
    with torch.no_grad():
        reset_launches()
        out = fwd()
        torch.cuda.synchronize()
        launches = launch_counts()
        want = expected({fmg.GENERIC_TAB_FWD.name: NUM_LAYERS})
        check(launches == want, f"{launches} kernel launches in one forward, expected {want}")
        check(tuple(out.shape) == (L2_POINTS, 3), f"output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "non-finite output")
        # the same (bf16) weights in fp32: through the kernel and the plain path
        state32 = {k: v.float() for k, v in model_bf.state_dict().items()}
        attrs_32 = (None, attrs32[1], None, attrs32[3])
        plain32 = port.SEGNN("2x0e+1x1o", L2_HIDDEN, "1x1o", lmax_attr=2, num_layers=NUM_LAYERS,
                             layout="cm", use_pallas=False, device=dev)
        plain32.load_state_dict(state32)
        ref = plain32(graph, attrs=attrs_32)
        del plain32
        model32 = port.SEGNN("2x0e+1x1o", L2_HIDDEN, "1x1o", lmax_attr=2, num_layers=NUM_LAYERS,
                             layout="cm", use_pallas=True, device=dev)
        model32.load_state_dict(state32)
        k32 = model32(graph, attrs=attrs_32)
        del model32
        scale = float(ref.abs().max())
        err32 = float((k32 - ref).abs().max())
        errbf = float((out.float() - ref).abs().max())
        emit("forward_lmax2", points=L2_POINTS, layers=NUM_LAYERS, hidden=L2_HIDDEN,
             dtype="bfloat16", shape=list(out.shape), launches=launches, max_abs_ref=scale,
             fp32_kernel_vs_plain_max_abs_err=err32,
             fp32_tolerance=f"{TOL_FORWARD_FP32} * max(1, |ref|); fp32 sums in another order",
             bf16_kernel_vs_fp32_plain_max_abs_err=errbf,
             bf16_tolerance=f"{TOL_FORWARD_BF16} * max|ref|; bf16 storage through 4 layers")
        check(bool(((k32 - ref).abs() <= TOL_FORWARD_FP32 * torch.clamp(ref.abs(), min=1.0)).all()),
              f"lmax=2 fp32 forward: kernel vs plain max abs err {err32}")
        check(errbf <= TOL_FORWARD_BF16 * scale, f"lmax=2 bf16 forward vs fp32 plain: {errbf}")
        del ref, k32, out

    # ---- 15. times (CUDA events after warm-up) and kernel #8's bound
    kb = kres[bf]
    cfg, args = kb["cfg"], kb["args"]
    plain_bf = port.SEGNN("2x0e+1x1o", L2_HIDDEN, "1x1o", lmax_attr=2, num_layers=NUM_LAYERS,
                          layout="cm", use_pallas=False, device=dev).to(bf)
    plain_bf.load_state_dict(model_bf.state_dict())
    with torch.no_grad():
        fwd_ms = event_ms(fwd, iters=3, warmup=1)
        fwd_plain_ms = event_ms(lambda: plain_bf(graph_bf, attrs=attrs_bf), iters=2, warmup=1)
        kern_ms = event_ms(lambda: fmg.generic_tab_fwd(cfg, *args), iters=5, warmup=1)
        plain_ms = event_ms(lambda: fmg.generic_tab_fwd_plain(cfg, *args), iters=2, warmup=1)
        k32 = kres[torch.float32]
        kern_fp32_ms = event_ms(lambda: fmg.generic_tab_fwd(k32["cfg"], *k32["args"]),
                                iters=2, warmup=1)
        out8 = fmg.generic_tab_fwd(cfg, *args)
    # bound: each input read once, the output written once; the multiply-adds
    # the valid slots need (the nonzeros of the folded weights) at the bf16
    # tensor-core peak and, beside it, at the fp32 FMA peak; the dense folded
    # GEMMs the kernel runs are reported beside them
    h, geo2, loc, gtab, ws, sels = args
    flops = kern.flops_per_slot() * kb["n_valid"]
    dense_flops = cfg.dense_flops_per_slot() * kb["n_valid"]
    n_bytes = nbytes(h, geo2, loc, gtab, *ws, *sels, out8)
    b_ms, by, bytes_ms, ops_ms = bound(n_bytes, flops)
    emit("times_lmax2", card=card, points=L2_POINTS, forward_ms=fwd_ms,
         forward_plain_path_ms=fwd_plain_ms, kernel_ms_per_launch=kern_ms,
         kernel_ms_per_forward=kern_ms * NUM_LAYERS, plain_ms_per_call=plain_ms,
         kernel_fp32_ms_per_launch=kern_fp32_ms,
         bound_ms=b_ms, bound_by=by, bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms,
         kernel_gflop=flops / 1e9, kernel_mbytes=n_bytes / 1e6, valid_slots=kb["n_valid"],
         flops_per_slot=kern.flops_per_slot(), dense_flops_per_slot=cfg.dense_flops_per_slot(),
         kernel_fp32_fma_bound_ms=flops / PEAK_FP32_FMA_FLOPS * 1e3,
         dense_gemm_gflop=dense_flops / 1e9,
         dense_gemm_bf16_ms=dense_flops / PEAK_BF16_FLOPS * 1e3,
         graph_build_ms=sum(gtimes.values()))
    row = dict(launches=launches[fmg.GENERIC_TAB_FWD.name], max_abs_err=kb["max_abs_err"],
               ms=kern_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by)
    del model_bf, plain_bf, out8
    return row, dict(graph=graph, kern=kern, kres=kres, gtimes=gtimes)


def bwd_compare(got, ref, elementwise: bool, fp32: bool,
                ulps_limit: float = TOL_GENERIC_BWD_BF16_ULPS) -> dict:
    """One output of a kernel against its plain version: fp32 elementwise
    (d_hu, d_hr, d_h, agg, ys) against 1e-4 * max(1, |ref|), or (weight
    gradients) against 1e-4 * max|ref|; bf16 elementwise in bf16 ulps of
    max(|ref|, mean|ref|) against ``ulps_limit``, with a limit on the share
    over 1 ulp."""
    err = (got.float() - ref.float()).abs()
    out = dict(max_abs_err=float(err.max()), max_abs_ref=float(ref.float().abs().max()))
    if fp32:
        scale = torch.clamp(ref.float().abs(), min=1.0) if elementwise else out["max_abs_ref"]
        out["over"] = int((err > TOL_BWD_FP32 * scale).sum())
    else:
        u = bf16_ulps(got, ref)
        out.update(max_ulps=float(u.max()), share_over_1ulp=float((u > 1).float().mean()),
                   over_ulps=int((u > ulps_limit).sum()))
        out["over"] = out["over_ulps"] + int(
            out["share_over_1ulp"] > TOL_GENERIC_BWD_BF16_OVER_1ULP)
    out["finite"] = bool(torch.isfinite(got.float()).all())
    return out


def explain_d_hs(cfg, args, d_agg, ys, got, ref, vjp: bool = False) -> dict:
    """The slot rows of the untabled d_hs [K, N, F] (bf16) that hold an
    element over TOL_GENERIC_BWD_BF16_ULPS: the kernel's chain (the mode of
    ``ys``) gives its dy_1 rows, and the plain last stage (``fmg._layer_dm``:
    dm_0 = sum_c (dy_1 * attr_c) W'_1,c^T) fed them is held against the
    kernel's d_hs rows, in ulps of the whole tensor's measure.  ``unexplained``
    counts the elements over the limit in rows where that does not hold
    within TOL_FLIP_REFED_ULPS.  For the record: the plain chain's dy_1 on
    the same rows, and how far the kernel's is from it (elements that differ,
    the largest difference in ulps of the element itself).  ``vjp``: #14's
    chain and last stage (``fmg._layer_vjp``), without that record."""
    hs, h, geo2, ws, sels = args
    k, n, f = got.shape
    floor = float(ref.float().abs().mean())
    u = bf16_ulps(got, ref, floor)
    bad = u > TOL_GENERIC_BWD_BF16_ULPS
    del u
    kk, ii = torch.nonzero(bad.any(dim=-1), as_tuple=True)
    rows = ii * k + kk  # node-major slot rows
    c1, da, _ = cfg.widths[0]
    a = cfg.a
    with torch.no_grad():
        dy1 = fmg.generic_bwd_chain(cfg, *args, d_agg, ys, vjp=vjp)[2][rows, :da]
        attr = geo2.reshape(n * k, a + 2)[rows, :a]
        if vjp:
            refed = fmg._layer_vjp(dy1, attr.float(), ws[0].float(), None, c1, a, 1)[0][:, :f]
        else:
            refed = fmg._layer_dm(dy1, attr, ws[0].float(), c1, a)[:, :f]
        r_ulps = bf16_ulps(got[kk, ii], refed, floor)
        unexplained = int((bad[kk, ii] & (r_ulps > TOL_FLIP_REFED_ULPS)).sum())
        if vjp:
            return dict(rows_over=int(rows.numel()), unexplained=unexplained,
                        refed_max_ulps=float(r_ulps.max()) if rows.numel() else 0.0)
        # the plain chain's dy_1 on the receivers of those rows
        recv = torch.unique(ii)
        sub = [hs[:, recv].contiguous(), h[recv], geo2[recv]]
        m0, at, mask = fmg._slot_rows_km(cfg, *sub, 0, recv.numel())
        ys_sub = None if ys is None else [
            y.reshape(n, k, -1)[recv].reshape(recv.numel() * k, -1) for y in ys]
        dys = []
        fmg._rows_bwd(cfg, m0, at, mask, [w.float() for w in ws], [s.long() for s in sels],
                      d_agg[recv], ys_sub, [torch.zeros_like(w, dtype=torch.float32) for w in ws],
                      dys)
        pos = torch.searchsorted(recv, ii) * k + kk
        p_dy1 = dys[0][pos]
        own = torch.clamp(p_dy1.float().abs(), min=1e-30)
        dy_diff = (dy1.float() - p_dy1.float()).abs() / torch.exp2(torch.floor(torch.log2(own)) - 7)
    return dict(rows_over=int(rows.numel()), unexplained=unexplained,
                refed_max_ulps=float(r_ulps.max()) if rows.numel() else 0.0,
                dy1_elements_differing=int((dy1 != p_dy1).sum()),
                dy1_max_ulps_of_element=float(dy_diff.max()) if rows.numel() else 0.0)


def km_exact_d_hs(cfg, args, ws, d_agg) -> torch.Tensor:
    """The untabled lmax=1 d_hs [K, N, F] of the plain backward with its
    sums in fp64 (``km_bwd_plain(acc=float64)``): the rounding points of the
    TPU kernel, each bf16 rounding of an exact sum; in receiver slices of
    about 600k slot rows."""
    hs3, hr, geo2 = args
    n, step = hr.shape[0], max(1, 600_000 // cfg.k)
    return torch.cat([fm.km_bwd_plain(cfg, hs3[:, i:i + step], hr[i:i + step],
                                      geo2[i:i + step], ws, d_agg[i:i + step],
                                      acc=torch.float64)[0]
                      for i in range(0, n, step)], dim=1)


def km_d_hs_check(cfg, args, ws, d_agg, got, ref, bwd) -> dict:
    """The untabled lmax=1 d_hs (bf16) against the exact-sum reference
    ``km_exact_d_hs``, every element: within ``limit`` bf16 ulps of
    max(|ref|, mean|ref|), limit = the larger of
    TOL_GENERIC_BWD_BF16_ULPS and the plain version's own worst distance
    from the same reference, and at most TOL_GENERIC_BWD_BF16_OVER_1ULP of
    the elements over 1 ulp.  Both planted faults must fail it: the
    kernel's d_hs with its largest element moved floor(limit) + 1 ulps, and
    ``bwd`` run with the cotangent of the receiver with most valid slots 5%
    off."""
    exact = km_exact_d_hs(cfg, args, ws, d_agg)
    floor = float(exact.float().abs().mean())
    u_plain = bf16_ulps(ref, exact, floor)
    limit = max(float(TOL_GENERIC_BWD_BF16_ULPS), float(u_plain.max()))

    def verdict(x):
        u = bf16_ulps(x, exact, floor)
        share = float((u > 1).float().mean())
        return dict(max_ulps=float(u.max()), share_over_1ulp=share,
                    over_ulps=int((u > limit).sum()),
                    over=int((u > limit).sum()) + int(share > TOL_GENERIC_BWD_BF16_OVER_1ULP))

    out = verdict(got)
    out.update(limit_ulps=limit, plain_max_ulps=float(u_plain.max()),
               plain_share_over_1ulp=float((u_plain > 1).float().mean()))
    del u_plain
    idx = int(exact.abs().argmax())
    v = float(exact.reshape(-1)[idx])
    one = got.clone().reshape(-1)
    one[idx] = v + (math.floor(limit) + 1) * 2.0 ** (math.floor(math.log2(abs(v))) - 7)
    planted = {"one_element": verdict(one.reshape(got.shape))}
    del one
    npad, k = args[1].shape[0], cfg.k
    r = int((args[2].reshape(npad, k, 6)[..., 5] > 0).sum(dim=1).argmax())
    d_off = d_agg.clone()
    d_off[r] = (d_off[r].float() * 1.05).to(d_off.dtype)
    planted["receiver_cotangent_x1.05"] = verdict(bwd(cfg, *args, ws, d_off)[0])
    out["planted"] = planted
    out["planted_caught"] = all(p["over"] > 0 for p in planted.values())
    return out


def bwd_outputs(res) -> list:
    """(d_hu, d_hr, [dW'_1, dW'_2]) -> [(name, tensor, elementwise)]."""
    return [("d_hu", res[0], True), ("d_hr", res[1], True), ("dW1", res[2][0], False),
            ("dW2", res[2][1], False)]


def train_run(model, graph, attrs, target, steps, card, phase, want, hidden=L2_HIDDEN, **info):
    """``steps`` counted bf16 train steps (fp32 masters, MSE, Adam 1e-3):
    checks the launches of every step against ``want``, finite losses and
    gradient norms and fp32 masters; returns the step function."""
    opt = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE, betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(model, bf16_loss, opt)
    losses, norms, per_step, step_ms = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        before = launch_counts()
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        m = step(graph, attrs, target)
        ev[1].record()
        losses.append(m["loss"].item())  # synchronises
        norms.append(m["grad_norm"].item())
        torch.cuda.synchronize()
        step_ms.append(ev[0].elapsed_time(ev[1]))
        per_step.append({k: v - before[k] for k, v in launch_counts().items()})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    masters = all(p.dtype == torch.float32 for p in model.parameters())
    emit(phase, **info, layers=NUM_LAYERS, hidden=hidden, steps=steps,
         compute_dtype="bfloat16", master_dtype="float32" if masters else "mixed",
         optimizer=f"Adam(lr={LEARNING_RATE}, betas=(0.9, 0.999), eps=1e-8)", losses=losses,
         grad_norms=norms, launches_per_step=per_step, seconds_incl_first_step=seconds,
         step_ms_events=step_ms, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)
    check(all(math.isfinite(x) for x in losses + norms),
          f"non-finite loss or norm: {losses} {norms}")
    check(all(s == want for s in per_step),
          f"{phase}: launches per step {per_step}, expected {want}")
    check(masters, "master weights are not all fp32")
    step.step_ms = step_ms
    return step


def lmax2_model(dev, use_pallas=True, **kw):
    return port.SEGNN("2x0e+1x1o", L2_HIDDEN, "1x1o", lmax_attr=2, num_layers=NUM_LAYERS,
                      layout="cm", use_pallas=use_pallas, device=dev,
                      generator=torch.Generator().manual_seed(SEED), **kw)


def geo_only(model, graph, dtype):
    """bench.py's geo-only attributes (None, node_attr, None, edge_geo)."""
    with torch.no_grad():
        a = model.compute_attributes_dense(graph)
    return (None, a[1].to(dtype), None, a[3].to(dtype))


def lmax2_train_phases(card: str, ctx: dict) -> dict:
    """Phases 16-20 (lmax=2 training); returns the ``kernels`` line's rows of
    #9, #10, the weight-gradient kernel and the table sum."""
    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    graph, kern, kres = ctx["graph"], ctx["kern"], ctx["kres"]
    tabs = (graph.gather_rev_dense, graph.gather_rem_pos, graph.gather_rem_node)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    res_kernels = (fmg.GENERIC_TAB_BWD_RES, fmg.GENERIC_TAB_BWD_REP)

    # ---- 16. #8's save mode, #9, #10 and their pieces against the plain versions
    bwd = {}
    with torch.no_grad():
        for dtype in (torch.float32, bf):
            fp32 = dtype == torch.float32
            cfg, args = kres[dtype]["cfg"], kres[dtype]["args"]
            h, geo2, loc, gtab, ws, sels = args
            d_agg = torch.randn((h.shape[0], cfg.out_dim), generator=gen, device=dev).to(dtype)
            agg, ys = fmg.generic_tab_fwd(cfg, *args, save=True)
            p_agg, p_ys = fmg.generic_tab_fwd_plain(cfg, *args, save=True)
            save = {nm: bwd_compare(x, y, True, fp32)
                    for nm, x, y in (("agg", agg, p_agg), ("y1", ys[0], p_ys[0]),
                                     ("y2", ys[1], p_ys[1]))}
            del p_agg, p_ys
            got = {"res": fmg.generic_tab_bwd_kernels(cfg, *args, d_agg, ys=ys),
                   "rep": fmg.generic_tab_bwd_kernels(cfg, *args, d_agg)}
            again = {"res": fmg.generic_tab_bwd_kernels(cfg, *args, d_agg, ys=ys),
                     "rep": fmg.generic_tab_bwd_kernels(cfg, *args, d_agg)}
            torch.cuda.synchronize()
            flat = lambda r: [r[0], r[1], *r[2]]
            identical = all(torch.equal(x, y) for m in got
                            for x, y in zip(flat(got[m]), flat(again[m])))
            res_eq_rep = all(torch.equal(x, y) for x, y in zip(flat(got["res"]), flat(got["rep"])))
            del again
            ref = {"res": fmg.generic_tab_bwd_plain(cfg, *args, d_agg, ys=ys),
                   "rep": fmg.generic_tab_bwd_plain(cfg, *args, d_agg)}
            cmp = {m: {nm: bwd_compare(x, y, el, fp32) for (nm, x, el), (_, y, _) in
                       zip(bwd_outputs(got[m]), bwd_outputs(ref[m]))} for m in got}
            # #9 against #10 within the fp32 limit
            cmp["res_vs_rep"] = {nm: bwd_compare(x, y, el, True) for (nm, x, el), (_, y, _) in
                                 zip(bwd_outputs(got["res"]), bwd_outputs(got["rep"]))}
            # each piece against its own plain version, on the chain's outputs
            d_hs, d_hr, dy1, dy2, m0, m1 = fmg.generic_tab_bwd_chain(cfg, *args, d_agg, ys)
            splits = fmg._wgrad_splits(cfg, h.shape[0] * cfg.k,
                                       torch.cuda.get_device_properties(dev).multi_processor_count)
            part = fmg.generic_tab_bwd_wgrad(cfg, geo2, m0, m1, dy1, dy2, splits)
            cmp["wgrad"] = {"partials": bwd_compare(part, fmg.generic_tab_bwd_wgrad_plain(
                cfg, geo2, m0, m1, dy1, dy2, splits), False, fp32)}
            d_hu = fmg.generic_tab_bwd_table(cfg, d_hs, loc)
            cmp["table"] = {"d_hu": bwd_compare(d_hu, fmg.generic_tab_bwd_table_plain(
                cfg, d_hs, loc), True, fp32)}
            dw = fm.tab_bwd_reduce(part)
            cmp["reduction"] = {"dW": bwd_compare(dw, fm.tab_bwd_reduce_plain(part), False, True)}
            # the full backward: kernels + epilogue against the plain backward + epilogue
            d_h = fmg.generic_sender_epilogue(got["res"][1], got["res"][0], *tabs)
            cmp["with_epilogue"] = {"d_h": bwd_compare(
                d_h, fmg.generic_sender_epilogue(ref["res"][1], ref["res"][0], *tabs), True, fp32)}
            torch.cuda.synchronize()
            bad = {f"{m}.{nm}": v for m, c in cmp.items() for nm, v in c.items()
                   if v["over"] or not v["finite"]}
            bad.update({f"save.{nm}": v for nm, v in save.items() if v["over"] or not v["finite"]})
            emit("kernel_bwd_lmax2", kernels=[k_.name for k_ in fmg.KERNELS[1:5]] +
                 [fm.TAB_BWD_REDUCE.name], dtype=str(dtype).replace("torch.", ""),
                 rows=h.shape[0], valid_slots=kres[dtype]["n_valid"], splits=splits,
                 save_mode=save, compared=cmp, bit_identical_reruns=identical,
                 res_bitwise_equal_rep=res_eq_rep,
                 tolerance=(f"{TOL_BWD_FP32} * max(1, |ref|) elementwise for agg, ys, d_hu, "
                            f"d_hr, d_h; {TOL_BWD_FP32} * max|ref| for dW' and the partials "
                            "(fp32 sums in another order)") if fp32 else
                 (f"{TOL_GENERIC_BWD_BF16_ULPS} bf16 ulps of max(|ref|, mean|ref|) "
                  f"elementwise and at most {TOL_GENERIC_BWD_BF16_OVER_1ULP} of the elements "
                  "over 1 ulp (kernel and plain version round at the same points; an fp32 "
                  "sum in another order flips a rounding of dy or dm now and then and the "
                  "sums carry it on); #9 vs #10 and the reduction at the fp32 limit"))
            check(not bad, f"lmax=2 backward kernels vs plain in {dtype}: {bad}")
            check(identical, f"two lmax=2 backward runs differ in {dtype}")
            # the bf16 inputs and outputs stay for the times (phase 20)
            bwd[dtype] = dict(cmp=cmp) if fp32 else dict(
                cfg=cfg, args=args, d_agg=d_agg, ys=ys, part=part,
                chain=(d_hs, d_hr, dy1, dy2, m0, m1), got=got["res"], cmp=cmp)
            del got, ref, d_h, dw, d_hs, d_hr, dy1, dy2, m0, m1, part, ys, d_hu

    # ---- 17. the 250k bf16 train step (bench.py:223-257), 3 steps, counted
    l2 = L2_POINTS
    model = lmax2_model(dev, remat=True)
    attrs_bf = geo_only(model, graph, bf)
    graph_bf = graph._replace(nodes=graph.nodes.to(bf))
    target = torch.from_numpy(np.random.default_rng(SEED + 9).standard_normal(
        (l2, 3)).astype(np.float32)).to(dev)
    per_layer = {fmg.GENERIC_TAB_FWD.name: NUM_LAYERS, fmg.GENERIC_TAB_BWD_WGRAD.name: NUM_LAYERS,
                 fmg.GENERIC_TAB_BWD_TABLE.name: NUM_LAYERS, fm.TAB_BWD_REDUCE.name: NUM_LAYERS}
    step = train_run(model, graph_bf, attrs_bf, target, L2_TRAIN_STEPS, card, "train_lmax2",
                     expected({**per_layer, fmg.GENERIC_TAB_BWD_RES.name: NUM_LAYERS}),
                     points=l2, backward="residual (#9)", remat=True)
    launches_250k = launch_counts()
    batch = (graph_bf, attrs_bf, target)
    step_ms_250k = event_ms(lambda: step(*batch), iters=3, warmup=1)
    prof = profile_steps(step, batch)
    check(prof["device_ms_per_step"] > 0, "the profiler saw no device time")
    del step, model, attrs_bf, graph_bf, target, batch

    # ---- 18. the 1M remat_kernel train step (bench.py:261-299), 2 steps, counted
    n1 = L1M_POINTS
    pts = np.random.default_rng(SEED + 10).random((n1, 3)).astype(np.float32)
    levels = max(4, search_level_for_radius(L1M_RADIUS, LO, HI) + 1)
    tile = SEGNNLayer._pick_generic_tile(n1)
    _, cap, edges, g1m, gtimes = build_graph(pts, radius=L1M_RADIUS, levels=levels,
                                             k=L2_NEIGHBORS, tile=tile)
    emit("graph_1m", points=n1, radius=L1M_RADIUS, k=L2_NEIGHBORS, cell_capacity=cap,
         octree_levels=levels, edges_cell=int(edges.num_edges),
         edges_symmetrized=int(g1m.edge_mask.sum()), tile=tile, table_size=g1m.gather_tab.shape[1],
         card=card, graph_build_ms=sum(gtimes.values()), **gtimes)
    check(g1m.gather_tile == tile and g1m.gather_loc.shape[0] == n1, "1M tables")
    del edges, pts
    model = lmax2_model(dev, remat=True, remat_kernel=True)
    check(all(layer._tab_eligible(n1, g1m) for layer in model.layers), "1M: not the tabled path")
    attrs_bf = geo_only(model, g1m, bf)
    g1m_bf = g1m._replace(nodes=g1m.nodes.to(bf))
    target = torch.from_numpy(np.random.default_rng(SEED + 11).standard_normal(
        (n1, 3)).astype(np.float32)).to(dev)
    step = train_run(model, g1m_bf, attrs_bf, target, L1M_TRAIN_STEPS, card, "train_1m",
                     expected({**per_layer, fmg.GENERIC_TAB_BWD_REP.name: NUM_LAYERS}),
                     points=n1, backward="replay (#10)", remat=True, remat_kernel=True)
    launches_1m = launch_counts()
    step_ms_1m = event_ms(lambda: step(g1m_bf, attrs_bf, target), iters=2, warmup=0)
    # this path's kernels against their plain versions at its own shapes (16M
    # slot rows; the chain's m_0 alone holds 3.1e9 values, past int32
    # offsets): #8 without save, #10 with the weight-gradient kernel, the table
    # sum and the reduction, and the epilogue; layer 0's folded weights after
    # the two steps, random features and cotangent, a masked tail
    kern1m = fmg.FusedMessageGeneric(model.layers[0].message_layers, L2_NEIGHBORS, tile)
    del step, model, g1m_bf, target
    gen1m = torch.Generator(device=dev).manual_seed(SEED + 14)
    tabs1m = (g1m.gather_rev_dense, g1m.gather_rem_pos, g1m.gather_rem_node)
    with torch.no_grad():
        cfg1m, args1m, n_valid_1m = generic_kernel_inputs(kern1m, g1m, attrs_bf[3], bf, gen1m)
        del attrs_bf
        d_agg1m = torch.randn((n1, cfg1m.out_dim), generator=gen1m, device=dev).to(bf)
        got = fmg.generic_tab_bwd_kernels(cfg1m, *args1m, d_agg1m)
        torch.cuda.synchronize()
        ref = fmg.generic_tab_bwd_plain(cfg1m, *args1m, d_agg1m)
        cmp1m = {nm: bwd_compare(x, y, el, False) for (nm, x, el), (_, y, _) in
                 zip(bwd_outputs(got), bwd_outputs(ref))}
        cmp1m["d_h"] = bwd_compare(fmg.generic_sender_epilogue(got[1], got[0], *tabs1m),
                                   fmg.generic_sender_epilogue(ref[1], ref[0], *tabs1m),
                                   True, False)
        d_hr1m = got[1]
        del got, ref
        cmp1m["agg"] = bwd_compare(fmg.generic_tab_fwd(cfg1m, *args1m),
                                   fmg.generic_tab_fwd_plain(cfg1m, *args1m), True, False)
        bad = {nm: v for nm, v in cmp1m.items() if v["over"] or not v["finite"]}
        emit("kernel_bwd_1m", kernels=[fmg.GENERIC_TAB_FWD.name, fmg.GENERIC_TAB_BWD_REP.name,
                                       fmg.GENERIC_TAB_BWD_WGRAD.name,
                                       fmg.GENERIC_TAB_BWD_TABLE.name, fm.TAB_BWD_REDUCE.name],
             dtype="bfloat16", rows=n1, slot_rows=n1 * L2_NEIGHBORS, u=cfg1m.u,
             valid_slots=n_valid_1m, compared=cmp1m,
             tolerance=(f"{TOL_GENERIC_BWD_BF16_ULPS} bf16 ulps of max(|ref|, mean|ref|) "
                        f"elementwise and at most {TOL_GENERIC_BWD_BF16_OVER_1ULP} of the "
                        "elements over 1 ulp, as kernel_bwd_lmax2 (the same rounding points; "
                        "fp32 sums in another order)"))
        check(not bad, f"1M: #8 / #10 vs plain: {bad}")
        # #10 whole and its plain version at these shapes, for the kernels line
        bwd10_1m_ms = event_ms(lambda: fmg.generic_tab_bwd_kernels(cfg1m, *args1m, d_agg1m),
                               iters=2, warmup=1)
        plain10_1m_ms = event_ms(lambda: fmg.generic_tab_bwd_plain(cfg1m, *args1m, d_agg1m),
                                 iters=1, warmup=0)
    h1, geo1, loc1, gtab1, ws1, sels1 = args1m
    nw1 = 4 * sum(w.numel() for w in ws1)
    whole10_1m = bound(nbytes(h1, geo1, loc1, gtab1, *ws1, *sels1, d_agg1m, d_hr1m) + nw1 +
                       gtab1.numel() * cfg1m.f * 2, 3 * kern1m.flops_per_slot() * n_valid_1m)
    del kern1m, args1m, d_agg1m, d_hr1m, h1, geo1, loc1, gtab1, ws1, sels1, tabs1m
    ctx["g1m"] = g1m  # the untabled sym-regather phases train on it again

    # ---- 19. fp32 gradients through #9 and through #10 against the plain path
    pts = np.random.default_rng(SEED + 12).random((GC2_POINTS, 3)).astype(np.float32)
    tile = SEGNNLayer._pick_generic_tile(GC2_POINTS)
    levels = max(4, search_level_for_radius(GC2_RADIUS, LO, HI) + 1)
    _, _, _, g_gc, _ = build_graph(pts, radius=GC2_RADIUS, levels=levels, k=L2_NEIGHBORS,
                                   tile=tile)
    t_gc = torch.from_numpy(np.random.default_rng(SEED + 13).standard_normal(
        (GC2_POINTS, 3)).astype(np.float32)).to(dev)
    m_p = lmax2_model(dev, use_pallas=False)
    attrs_gc = geo_only(m_p, g_gc, torch.float32)
    torch.cuda.reset_peak_memory_stats()
    loss_p = mse_loss(m_p(g_gc, attrs=attrs_gc), t_gc)
    loss_p.backward()
    ref = {nm: p.grad for nm, p in m_p.named_parameters()}
    peak_plain = torch.cuda.max_memory_allocated() / 1e9
    gc = {}
    for mode, kw, kern_ in (("residual", {}, fmg.GENERIC_TAB_BWD_RES),
                            ("remat_kernel", dict(remat=True, remat_kernel=True),
                             fmg.GENERIC_TAB_BWD_REP)):
        m_k = lmax2_model(dev, **kw)
        m_k.load_state_dict(m_p.state_dict())
        check(all(layer._tab_eligible(GC2_POINTS, g_gc) for layer in m_k.layers),
              "gradient check: not the tabled path")
        before = kern_.launches
        loss_k = mse_loss(m_k(g_gc, attrs=attrs_gc), t_gc)
        loss_k.backward()
        worst, worst_name = 0.0, ""
        for nm, p in m_k.named_parameters():
            rel = float((p.grad - ref[nm]).abs().max()) / max(float(ref[nm].abs().max()), 1e-30)
            if rel > worst:
                worst, worst_name = rel, nm
        gc[mode] = dict(loss_kernel=loss_k.item(), worst_param=worst_name, worst_rel_err=worst,
                        launches=kern_.launches - before)
        check(kern_.launches - before == NUM_LAYERS,
              f"gradient check {mode}: {kern_.name} launches")
        check(worst <= TOL_GRAD_FP32,
              f"lmax=2 fp32 gradients ({mode}): {worst_name} off by {worst}")
        check(abs(loss_k.item() - loss_p.item()) <= 1e-5 * loss_p.item(), f"losses differ ({mode})")
        del m_k, loss_k
    emit("grad_check_lmax2", points=GC2_POINTS, radius=GC2_RADIUS, k=L2_NEIGHBORS, tile=tile,
         layers=NUM_LAYERS, dtype="float32", edges_symmetrized=int(g_gc.edge_mask.sum()),
         loss_plain=loss_p.item(), modes=gc, peak_mem_gb_plain_path=peak_plain,
         tolerance=f"{TOL_GRAD_FP32} * max|ref| per parameter; fp32 sums in another order")
    del m_p, ref, g_gc, attrs_gc, loss_p

    # ---- 20. times (CUDA events) of the lmax=2 backward kernels, their plain
    # versions, the reduction and the epilogue at the 250k bf16 shapes; bounds
    b = bwd[bf]
    cfg, args, d_agg, ys, part = b["cfg"], b["args"], b["d_agg"], b["ys"], b["part"]
    h, geo2, loc, gtab, ws, sels = args
    d_hs, d_hr, dy1, dy2, m0, m1 = b["chain"]
    splits = part.shape[0]
    n_valid = kres[bf]["n_valid"]
    with torch.no_grad():
        t = dict(
            save_fwd_ms=event_ms(lambda: fmg.generic_tab_fwd(cfg, *args, save=True), iters=3,
                                 warmup=1),
            res_ms=event_ms(lambda: fmg.generic_tab_bwd_chain(cfg, *args, d_agg, ys), iters=3,
                            warmup=1),
            rep_ms=event_ms(lambda: fmg.generic_tab_bwd_chain(cfg, *args, d_agg), iters=3,
                            warmup=1),
            wgrad_ms=event_ms(lambda: fmg.generic_tab_bwd_wgrad(
                cfg, geo2, m0, m1, dy1, dy2, splits), iters=3, warmup=1),
            table_ms=event_ms(lambda: fmg.generic_tab_bwd_table(cfg, d_hs, loc), iters=5),
            reduce_ms=event_ms(lambda: fm.tab_bwd_reduce(part), iters=10),
            reduce_plain_ms=event_ms(lambda: fm.tab_bwd_reduce_plain(part), iters=10),
            epilogue_ms=event_ms(lambda: fmg.generic_sender_epilogue(
                b["got"][1], b["got"][0], *tabs), iters=5),
            bwd9_ms=event_ms(lambda: fmg.generic_tab_bwd_kernels(cfg, *args, d_agg, ys=ys),
                             iters=3, warmup=1),
            bwd10_ms=event_ms(lambda: fmg.generic_tab_bwd_kernels(cfg, *args, d_agg), iters=3,
                              warmup=1),
            plain_res_ms=event_ms(lambda: fmg.generic_tab_bwd_plain(cfg, *args, d_agg, ys=ys),
                                  iters=2, warmup=1),
            plain_rep_ms=event_ms(lambda: fmg.generic_tab_bwd_plain(cfg, *args, d_agg),
                                  iters=2, warmup=1),
            wgrad_plain_ms=event_ms(lambda: fmg.generic_tab_bwd_wgrad_plain(
                cfg, geo2, m0, m1, dy1, dy2, splits), iters=2, warmup=1),
            table_plain_ms=event_ms(lambda: fmg.generic_tab_bwd_table_plain(cfg, d_hs, loc),
                                    iters=3, warmup=1),
            # the one PyTorch call that computes the table sum: index_add_
            table_library_ms=event_ms(lambda: torch.zeros(
                (gtab.numel() + 1, cfg.f), dtype=torch.float32, device=dev).index_add_(
                0, torch.where(loc.reshape(-1) < cfg.u, (torch.arange(
                    loc.numel(), device=dev) // (cfg.tile * cfg.k)) * cfg.u + loc.reshape(-1),
                    gtab.numel()), d_hs.float()), iters=3, warmup=1))
    # bounds: inputs read once, outputs written once; the multiply-adds the
    # valid slots need (the folded nonzeros: one pass = flops_per_slot) at the
    # bf16 tensor-core peak; the dense folded GEMMs beside them
    fps, dense = kern.flops_per_slot(), cfg.dense_flops_per_slot()
    wsz = nbytes(*ws, *sels)
    res_bytes = nbytes(h, geo2, loc, gtab, *ys, d_agg, d_hs, d_hr, dy1, dy2, m0, m1) + wsz
    rep_bytes = nbytes(h, geo2, loc, gtab, d_agg, d_hs, d_hr, dy1, dy2, m0, m1) + wsz
    wgrad_bytes = nbytes(geo2, m0, m1, dy1, dy2, part)
    table_bytes = nbytes(d_hs, loc) + gtab.numel() * cfg.f * 2
    bounds = {  # the pieces as designed, each from the rows it reads and writes
        "chain_res": bound(res_bytes, fps * n_valid),
        "chain_rep": bound(rep_bytes, 2 * fps * n_valid),
        fmg.GENERIC_TAB_BWD_WGRAD.name: bound(wgrad_bytes, fps * n_valid),
        fmg.GENERIC_TAB_BWD_TABLE.name: bound(table_bytes, n_valid * cfg.f, PEAK_FP32_FMA_FLOPS),
    }
    # #9 and #10 whole (chain + weight gradients + table sum): the bytes of
    # their inputs and outputs, 2 (#9) and 3 (#10) passes of the folded products
    nw_bytes = 4 * part.shape[1]
    whole9 = bound(nbytes(h, geo2, loc, gtab, *ys, d_agg, d_hr) + wsz + nw_bytes +
                   gtab.numel() * cfg.f * 2, 2 * fps * n_valid)
    whole10 = bound(nbytes(h, geo2, loc, gtab, d_agg, d_hr) + wsz + nw_bytes +
                    gtab.numel() * cfg.f * 2, 3 * fps * n_valid)
    red_bound = bound(nbytes(part) + nw_bytes, part.numel(), PEAK_FP32_FMA_FLOPS)
    emit("train_times_lmax2", card=card, step_ms_250k=step_ms_250k, step_ms_1m=step_ms_1m,
         **t, valid_slots=n_valid, flops_per_slot_pass=fps, dense_flops_per_slot_pass=dense,
         bounds={k_: dict(bound_ms=v[0], bound_by=v[1], bytes_ms=v[2], ops_ms=v[3])
                 for k_, v in bounds.items()},
         dense_gemm_bf16_ms={"res": dense * n_valid / PEAK_BF16_FLOPS * 1e3,
                             "rep": 2 * dense * n_valid / PEAK_BF16_FLOPS * 1e3,
                             "wgrad": dense * n_valid / PEAK_BF16_FLOPS * 1e3},
         bwd9_whole_bound=dict(bound_ms=whole9[0], bound_by=whole9[1], bytes_ms=whole9[2],
                               ops_ms=whole9[3], dense_gemm_bf16_ms=2 * dense * n_valid /
                               PEAK_BF16_FLOPS * 1e3),
         bwd10_whole_bound=dict(bound_ms=whole10[0], bound_by=whole10[1], bytes_ms=whole10[2],
                                ops_ms=whole10[3], dense_gemm_bf16_ms=3 * dense * n_valid /
                                PEAK_BF16_FLOPS * 1e3),
         bwd10_1m_ms=bwd10_1m_ms, plain_rep_1m_ms=plain10_1m_ms, valid_slots_1m=n_valid_1m,
         bwd10_1m_whole_bound=dict(bound_ms=whole10_1m[0], bound_by=whole10_1m[1],
                                   bytes_ms=whole10_1m[2], ops_ms=whole10_1m[3],
                                   dense_gemm_bf16_ms=3 * dense * n_valid_1m /
                                   PEAK_BF16_FLOPS * 1e3),
         reduce_bound_ms=red_bound[0], reduce_blocks=splits, profile_250k=prof)

    # #9 and #10 are the whole backward (chain + weight-gradient kernel + table
    # sum + reduction), each on its main path's shapes (#9 250k, #10 1M),
    # against the bound of the TPU function's own inputs and outputs; the
    # weight-gradient kernel and the table sum are pieces of both, bound by
    # the bytes of the rows the chain writes for them
    cmp = bwd[bf]["cmp"]
    whole = ("d_hu", "d_hr", "dW1", "dW2")
    piece = dict(piece_of=[fmg.GENERIC_TAB_BWD_RES.name, fmg.GENERIC_TAB_BWD_REP.name])
    rows = {
        fmg.GENERIC_TAB_BWD_RES.name: dict(
            launches=launches_250k[fmg.GENERIC_TAB_BWD_RES.name],
            max_abs_err=max(cmp["res"][nm]["max_abs_err"] for nm in whole), ms=t["bwd9_ms"],
            plain_ms=t["plain_res_ms"], bound_ms=whole9[0], bound_by=whole9[1],
            library_ms=None, chain_ms=t["res_ms"]),
        fmg.GENERIC_TAB_BWD_REP.name: dict(
            launches=launches_1m[fmg.GENERIC_TAB_BWD_REP.name],
            max_abs_err=max(cmp1m[nm]["max_abs_err"] for nm in whole), ms=bwd10_1m_ms,
            plain_ms=plain10_1m_ms, bound_ms=whole10_1m[0], bound_by=whole10_1m[1],
            library_ms=None),
        fmg.GENERIC_TAB_BWD_WGRAD.name: dict(
            launches=launches_250k[fmg.GENERIC_TAB_BWD_WGRAD.name],
            max_abs_err=cmp["wgrad"]["partials"]["max_abs_err"], ms=t["wgrad_ms"],
            plain_ms=t["wgrad_plain_ms"], bound_ms=bounds[fmg.GENERIC_TAB_BWD_WGRAD.name][0],
            bound_by=bounds[fmg.GENERIC_TAB_BWD_WGRAD.name][1], library_ms=None, **piece),
        fmg.GENERIC_TAB_BWD_TABLE.name: dict(
            launches=launches_250k[fmg.GENERIC_TAB_BWD_TABLE.name],
            max_abs_err=cmp["table"]["d_hu"]["max_abs_err"], ms=t["table_ms"],
            plain_ms=t["table_plain_ms"], bound_ms=bounds[fmg.GENERIC_TAB_BWD_TABLE.name][0],
            bound_by=bounds[fmg.GENERIC_TAB_BWD_TABLE.name][1],
            library_ms=t["table_library_ms"], **piece),
    }
    return rows


NO_TABLES = dict(gather_loc=None, gather_tab=None, gather_rev=None, gather_tile=0,
                 gather_rev_dense=None, gather_rem_pos=None, gather_rem_node=None)
UNTAB_OUTPUTS = (("d_hs", True), ("d_hr", True), ("dW1", False), ("dW2", False))


def untabled_inputs(kern, senders, edge_geo, h_ext, lo, hi, dtype, gen):
    """#11-#13's arguments for the receivers [lo, hi) of a graph, as the
    model hands them over: hs = h_ext[senders.T] (clamped) [K, hi-lo, F], the
    receivers' rows, the geometry with extra masked slots and a masked tail
    (the last 37 receivers without a valid slot), layer-0's folded weights.
    Returns (cfg, args, valid slots)."""
    n, k = hi - lo, senders.shape[1]
    dev = senders.device
    a = edge_geo.shape[1] // k - 2
    cfg = kern.config(a, 0)
    geo = edge_geo[lo:hi].float().reshape(n, k, a + 2)
    geo[..., a + 1] *= (torch.rand((n, k), generator=gen, device=dev) > 0.1).float()
    geo[n - 37:, :, a + 1] = 0.0
    n_valid = int((geo[..., a + 1] > 0).sum())
    hs = h_ext[torch.clamp(senders[lo:hi].t(), max=h_ext.shape[0] - 1).long().contiguous()]
    args = (hs.to(dtype).contiguous(), h_ext[lo:hi].to(dtype).contiguous(),
            geo.reshape(n, -1).to(dtype).contiguous(),
            [w.contiguous() for w in kern.fold(dtype)], kern.selections(dev))
    return cfg, args, n_valid


def untabled_check(label, kern, cfg, args, n_valid, d_agg, times: bool) -> dict:
    """#11 (without and with save), #12 and #13 (whole: chain, weight
    gradients, reduction) against their plain versions on one set of
    inputs; #12 against #13 bitwise; two runs of each bitwise equal.  With
    ``times``, CUDA-event times of each and of its plain version, device
    times per launch of the kernels (torch.profiler), and the bounds.  Emits a ``kernel_untabled`` line; returns its numbers."""
    fp32 = args[1].dtype == torch.float32
    hs, h, geo2, ws, sels = args
    with torch.no_grad():
        agg = fmg.generic_fwd(cfg, *args)
        agg_s, ys = fmg.generic_fwd(cfg, *args, save=True)
        save_same = torch.equal(agg, agg_s)
        p_agg, p_ys = fmg.generic_fwd_plain(cfg, *args, save=True)
        cmp = {nm: bwd_compare(x, y, True, fp32)
               for nm, x, y in (("agg", agg, p_agg), ("y1", ys[0], p_ys[0]), ("y2", ys[1], p_ys[1]))}
        del agg_s, p_agg, p_ys
        flat = lambda r: [r[0], r[1], *r[2]]
        res = flat(fmg.generic_bwd_kernels(cfg, *args, d_agg, ys=ys))
        rep = flat(fmg.generic_bwd_kernels(cfg, *args, d_agg))
        torch.cuda.synchronize()
        res_eq_rep = all(torch.equal(x, y) for x, y in zip(res, rep))
        identical = all(torch.equal(x, y) for x, y in zip(
            res, flat(fmg.generic_bwd_kernels(cfg, *args, d_agg, ys=ys)))) and all(
            torch.equal(x, y) for x, y in zip(rep, flat(fmg.generic_bwd_kernels(cfg, *args, d_agg))))
        ref = flat(fmg.generic_bwd_plain(cfg, *args, d_agg))
        for (nm, el), x, y, z in zip(UNTAB_OUTPUTS, res, rep, ref):
            cmp[f"res.{nm}"] = bwd_compare(x, z, el, fp32)
            cmp[f"rep.{nm}"] = bwd_compare(y, z, el, fp32)
        for mode, got, ys_m in (("res", res[0], ys), ("rep", rep[0], None)):
            c = cmp[f"{mode}.d_hs"]
            if not fp32 and c["over_ulps"]:
                c["explained"] = explain_d_hs(cfg, args, d_agg, ys_m, got, ref[0])
                c["over"] = c["explained"]["unexplained"] + int(
                    c["share_over_1ulp"] > TOL_GENERIC_BWD_BF16_OVER_1ULP)
        torch.cuda.synchronize()
    out = dict(label=label, dtype=str(h.dtype).replace("torch.", ""), rows=h.shape[0], k=cfg.k,
               valid_slots=n_valid, compared=cmp, save_agg_equal=save_same,
               res_bitwise_equal_rep=res_eq_rep, bit_identical_reruns=identical,
               max_abs_err=dict(fwd=cmp["agg"]["max_abs_err"],
                                res=max(cmp[f"res.{nm}"]["max_abs_err"] for nm, _ in UNTAB_OUTPUTS),
                                rep=max(cmp[f"rep.{nm}"]["max_abs_err"] for nm, _ in UNTAB_OUTPUTS)))
    if times:
        with torch.no_grad():
            _, _, dy1, dy2, _, m1 = fmg.generic_bwd_chain(cfg, *args, d_agg)
            rows = (m1, dy1, dy2)
            splits = fmg._wgrad_splits(cfg, m1.shape[0], torch.cuda.get_device_properties(
                h.device).multi_processor_count)
            t = dict(
                fwd_ms=event_ms(lambda: fmg.generic_fwd(cfg, *args), iters=5, warmup=1),
                save_ms=event_ms(lambda: fmg.generic_fwd(cfg, *args, save=True), iters=3, warmup=1),
                fwd_plain_ms=event_ms(lambda: fmg.generic_fwd_plain(cfg, *args), iters=1),
                res_ms=event_ms(lambda: fmg.generic_bwd_kernels(cfg, *args, d_agg, ys=ys), iters=3,
                                warmup=1),
                rep_ms=event_ms(lambda: fmg.generic_bwd_kernels(cfg, *args, d_agg), iters=3,
                                warmup=1),
                rep_chain_ms=event_ms(lambda: fmg.generic_bwd_chain(cfg, *args, d_agg), iters=3,
                                      warmup=1),
                rep_wgrad_ms=event_ms(lambda: fmg.generic_bwd_wgrad(cfg, hs, h, geo2, *rows, splits),
                                      iters=3, warmup=1),
                res_plain_ms=event_ms(lambda: fmg.generic_bwd_plain(cfg, *args, d_agg, ys=ys),
                                      iters=1),
                rep_plain_ms=event_ms(lambda: fmg.generic_bwd_plain(cfg, *args, d_agg), iters=1))
            # device time per launch (torch.profiler, one trace) of each
            # kernel, beside the CUDA-event times per call above
            t["device_ms"] = kernels_device_ms(
                [lambda: fmg.generic_fwd(cfg, *args),
                 lambda: fmg.generic_bwd_chain(cfg, *args, d_agg),
                 lambda: fmg.generic_bwd_chain(cfg, *args, d_agg, ys=ys),
                 lambda: fm.tab_bwd_reduce(fmg.generic_bwd_wgrad(cfg, hs, h, geo2, *rows,
                                                                 splits))],
                dict(fwd=("generic_fwd_kernel",), rep_chain=("chain_kernel", "Mode)1"),
                     res_chain=("chain_kernel", "Mode)0"), wgrad=("wgrad_kernel",),
                     reduce=("tab_bwd_reduce",)))
            del rows, dy1, dy2, m1
        # bounds: each input read once, each output written once; 1 (#11), 2
        # (#12) and 3 (#13) passes of the folded weights' nonzeros per valid
        # slot at the bf16 tensor-core peak
        fps = kern.flops_per_slot()
        wsz = nbytes(*ws, *sels)
        io = nbytes(hs, h, geo2) + wsz
        dws = 4 * sum(w.numel() for w in ws)
        grads = nbytes(d_agg, res[0], res[1]) + dws
        t["bounds"] = {k_: dict(zip(("bound_ms", "bound_by", "bytes_ms", "ops_ms"), v)) for k_, v in (
            ("fwd", bound(io + nbytes(agg), fps * n_valid)),
            ("save", bound(io + nbytes(agg, *ys), fps * n_valid)),
            ("res", bound(io + nbytes(*ys) + grads, 2 * fps * n_valid)),
            ("rep", bound(io + grads, 3 * fps * n_valid)))}
        out["times"] = t
    emit("kernel_untabled", kernels=[fmg.GENERIC_FWD.name, fmg.GENERIC_BWD_RES.name,
                                     fmg.GENERIC_BWD_REP.name, fmg.GENERIC_TAB_BWD_WGRAD.name,
                                     fm.TAB_BWD_REDUCE.name], **out,
         tolerance=(f"{TOL_BWD_FP32} * max(1, |ref|) elementwise for agg, ys, d_hs, d_hr; "
                    f"{TOL_BWD_FP32} * max|ref| for dW' (fp32 sums in another order)") if fp32 else
         (f"{TOL_GENERIC_BWD_BF16_ULPS} bf16 ulps of max(|ref|, mean|ref|) elementwise and at "
          f"most {TOL_GENERIC_BWD_BF16_OVER_1ULP} of the elements over 1 ulp (kernel and plain "
          "version round at the same points); a d_hs element over the limit passes only if the "
          "plain last stage fed the kernel's dy_1 of its slot row gives the kernel's row within "
          f"{TOL_FLIP_REFED_ULPS} ulp; #12 = #13 and reruns bitwise"))
    bad = {nm: v for nm, v in cmp.items() if v["over"] or not v["finite"]}
    check(not bad, f"{label}: untabled kernels vs plain in {h.dtype}: {bad}")
    check(save_same and res_eq_rep and identical,
          f"{label}: save mode {save_same}, #12 = #13 {res_eq_rep}, reruns {identical}")
    return out


def untabled_phases(card: str, ctx: dict) -> dict:
    """Phases 21-23: the lmax=2 train steps on the graphs without gather
    tables (the runner's paths below 2M points) and the untabled kernels
    against their plain versions at their shapes.

    21. train_untabled_250k -- bench.py's 250k step (``remat``, residual
        backward) on the 250k graph with its tables dropped: per step 4 of
        #11 (in save mode), 4 of #12, and no #8/#9/#10/#13.
    22. train_sym_1m -- bench.py's 1M ``remat_kernel`` step on the 1M graph
        with its tables dropped: the sym-regather entry, per step 4 of #11
        and 4 of #13, no #8/#9/#10/#12.
    23. kernel_untabled at the 250k and 1M shapes (bf16), #12's times at
        250k.  Returns #12's row of the ``kernels`` line."""
    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    per_layer = {fmg.GENERIC_FWD.name: NUM_LAYERS, fmg.GENERIC_TAB_BWD_WGRAD.name: NUM_LAYERS,
                 fm.TAB_BWD_REDUCE.name: NUM_LAYERS}
    # ---- 21. 250k, residual, untabled
    g250 = ctx["graph"]._replace(**NO_TABLES)
    model = lmax2_model(dev, remat=True)
    check(not any(layer._tab_eligible(L2_POINTS, g250) or layer._sym_regather_eligible(
        L2_POINTS, True) for layer in model.layers), "250k: not the untabled residual path")
    attrs_bf = geo_only(model, g250, bf)
    g_bf = g250._replace(nodes=g250.nodes.to(bf))
    target = torch.from_numpy(np.random.default_rng(SEED + 15).standard_normal(
        (L2_POINTS, 3)).astype(np.float32)).to(dev)
    step = train_run(model, g_bf, attrs_bf, target, L2_TRAIN_STEPS, card, "train_untabled_250k",
                     expected({**per_layer, fmg.GENERIC_BWD_RES.name: NUM_LAYERS}),
                     points=L2_POINTS, backward="residual (#12)", remat=True, tables=False)
    launches_250k = launch_counts()
    step_ms_250k = event_ms(lambda: step(g_bf, attrs_bf, target), iters=2, warmup=0)
    kern250 = fmg.FusedMessageGeneric(model.layers[0].message_layers, L2_NEIGHBORS,
                                      SEGNNLayer._pick_generic_tile(L2_POINTS))
    del step, model, target
    # ---- 22. 1M, remat_kernel, sym-regather
    n1 = L1M_POINTS
    g1m = ctx.pop("g1m")._replace(**NO_TABLES)
    model = lmax2_model(dev, remat=True, remat_kernel=True)
    check(all(layer._sym_regather_eligible(n1, g1m.reverse_slot is not None)
              and not layer._tab_eligible(n1, g1m) for layer in model.layers),
          "1M: not the sym-regather path")
    attrs1 = geo_only(model, g1m, bf)
    g1_bf = g1m._replace(nodes=g1m.nodes.to(bf))
    target = torch.from_numpy(np.random.default_rng(SEED + 16).standard_normal(
        (n1, 3)).astype(np.float32)).to(dev)
    step = train_run(model, g1_bf, attrs1, target, L1M_TRAIN_STEPS, card, "train_sym_1m",
                     expected({**per_layer, fmg.GENERIC_BWD_REP.name: NUM_LAYERS}),
                     points=n1, backward="replay (#13), sym-regather", remat=True,
                     remat_kernel=True, tables=False)
    step_ms_1m = step.step_ms[-1]
    kern1m = fmg.FusedMessageGeneric(model.layers[0].message_layers, L2_NEIGHBORS,
                                      SEGNNLayer._pick_generic_tile(n1), residual_bwd=False)
    del step, model, target, g1_bf
    # ---- 23. the kernels at the 1M and 250k shapes (bf16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    out = {}
    for label, kern, g, attrs in (("sym_1m", kern1m, g1m, attrs1),
                                  ("untabled_250k", kern250, g250, attrs_bf)):
        n = g.senders.shape[0]
        h_ext = torch.randn((n, kern.config(9, 0).f), generator=gen, device=dev)
        cfg, args, n_valid = untabled_inputs(kern, g.senders, attrs[3], h_ext, 0, n, bf, gen)
        del h_ext
        d_agg = torch.randn((n, cfg.out_dim), generator=gen, device=dev).to(bf)
        out[label] = untabled_check(label, kern, cfg, args, n_valid, d_agg,
                                    times=label == "untabled_250k")
        del cfg, args, d_agg
    ctx["g1m_untabled"] = g1m  # #14's 1M remat_kernel step trains on it again
    del g1m, attrs1, g250, attrs_bf, g_bf
    t = out["untabled_250k"]["times"]
    emit("untabled_times", card=card, step_ms_250k=step_ms_250k, step_ms_sym_1m=step_ms_1m,
         kernels_250k=t)
    return {fmg.GENERIC_BWD_RES.name: dict(
        launches=launches_250k[fmg.GENERIC_BWD_RES.name],
        max_abs_err=out["untabled_250k"]["max_abs_err"]["res"], ms=t["res_ms"],
        plain_ms=t["res_plain_ms"], bound_ms=t["bounds"]["res"]["bound_ms"],
        bound_by=t["bounds"]["res"]["bound_by"], library_ms=None)}


def approx2_phase(card: str, tree, cap: int, exact, exact_ms: float) -> None:
    """Phase 24b, graph_10m_approx2: bench.py:111-126's build of the 10M
    graph (10 segments, selection "approx2", approx_recall 0.85) on the
    config-5 tree, timed beside the exact build; its recall of the exact
    build's edges (at least 0.85) and every edge within 1.02 r (its bf16
    keys at the cutoff)."""
    n = tree.num_points
    e2, ms = sync_time(lambda: port.radius_graph_cell_segments(
        tree, C5_RADIUS, LO, HI, max_neighbors=L2_NEIGHBORS, cell_capacity=cap,
        num_segments=C5_SEGMENTS, selection="approx2", approx_recall=APPROX2_RECALL))
    key = lambda e: (e.receivers.long() * n + e.senders.long())[e.mask]
    k_exact = key(exact)
    recall = float(torch.isin(k_exact, key(e2)).sum()) / max(k_exact.numel(), 1)
    del k_exact
    pts = tree.points
    far = float((torch.linalg.vector_norm(pts[e2.receivers.long()[e2.mask]]
                                          - pts[e2.senders.long()[e2.mask]], dim=-1)).max())
    emit("graph_10m_approx2", card=card, points=n, radius=C5_RADIUS, k=L2_NEIGHBORS,
         cell_capacity=cap, segments=C5_SEGMENTS, approx_recall=APPROX2_RECALL,
         radius_approx2_ms=ms, radius_exact_ms=exact_ms, ratio_approx2_over_exact=ms / exact_ms,
         edges_approx2=int(e2.num_edges), edges_exact=int(exact.num_edges),
         recall_vs_exact=recall, max_edge_over_radius=far / C5_RADIUS,
         limits=f"recall >= {APPROX2_RECALL}; every edge <= {APPROX2_SLACK} r")
    check(recall >= APPROX2_RECALL, f"approx2 recall {recall} < {APPROX2_RECALL}")
    check(far <= APPROX2_SLACK * C5_RADIUS, f"approx2 edge of {far / C5_RADIUS} r")
    partition_10m(card, tree, e2)


def partition_10m(card: str, tree, edges) -> None:
    """Phase 24c, partition_10m: bench.py:128-140's partition_s_10m_p16,
    ``partition_graph_dense`` at P=16 on the host over the 10M approx2 graph
    (the device-to-host copies outside the timed region), through the native
    helpers of ``data.native_loader``; every valid slot kept once."""
    n = tree.num_points
    senders = edges.senders.reshape(n, L2_NEIGHBORS).cpu().numpy()
    mask = edges.mask.reshape(n, L2_NEIGHBORS).cpu().numpy()
    pts = tree.points.cpu().numpy()
    feats = np.zeros((n, 5), np.float32)
    native = native_loader.available()
    t0 = time.perf_counter()
    part = partition_graph_dense(pts, feats, senders, mask, num_parts=PARTITION_10M_PARTS)
    seconds = time.perf_counter() - t0
    kept = int(part.mask_int.sum()) + int(part.mask_bnd.sum())
    emit("partition_10m", card=card, points=n, k=L2_NEIGHBORS, num_parts=PARTITION_10M_PARTS,
         native=native, partition_s_10m_p16=seconds, n_interior=part.n_interior,
         n_boundary=part.n_boundary, halo_cap=part.halo_cap, q_int=part.rev_int.shape[-1],
         q_ext=part.rev_ext.shape[-1], slots_kept=kept, slots_valid=int(mask.sum()),
         clock="host, perf_counter; the graph's device-to-host copies outside it")
    check(native, "the native partitioner helpers did not build")
    check(kept == int(mask.sum()), f"the P=16 partition keeps {kept} of {int(mask.sum())} slots")


def config5_phases(card: str) -> dict:
    """Phases 24-27: config 5 (bench_scaling.py:113-240), the 10M-point
    single-chip train step, at full size and width.

    24. graph_10m -- 10M uniform points (default_rng(0)), r = 0.04 (1e5 /
        1e7)^(1/3), K=16, octree max(4, search level + 1) levels, cell
        capacity by suggest_cell_capacity, radius_graph_cell_segments (10
        segments, the exact "sort" selection), not symmetrized; geo-only bf16
        attributes by SEGNN.compute_attributes_dense_chunked; times.
    25. kernel_untabled at one node block's shapes (400k receivers, K=16,
        tile 200, senders anywhere in the 10M graph), fp32 and bf16, with
        the times of #11 and #13 and their bounds.
    26. train_config5 -- edge_chunks=25, remat, remat_kernel, remat_layers=2;
        bf16 compute on fp32 masters, MSE, Adam 1e-3; one warm-up and one
        timed step (CUDA events); loss, peak memory.  Launches per step,
        with L = 4 layers and C = 25 node blocks: the replay backward #13
        once per layer and block, L C = 100; the forward #11 three times per
        layer and block, 3 L C = 300: once in the forward, once when the
        backward of a layer group (remat_layers=2) recomputes the group,
        whose block checkpoints run their blocks again, and once when each
        block's own checkpoint recomputes it for its backward; the weight-
        gradient kernel and the reduction with #13 (100 each); no
        #8/#9/#10/#12 and no table sum.
    27. grad_check_config5 -- fp32 gradients of the chunked model
        (edge_chunks=4, remat_layers=2, remat_kernel) against autograd
        through the plain path, 20k points at the 10M density.
    Returns the rows of #11 and #13 for the ``kernels`` line."""
    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    n = C5_POINTS
    rng = np.random.default_rng(0)  # bench_scaling.py's generator, in its order
    pts = rng.random((n, 3)).astype(np.float32)
    levels = max(4, search_level_for_radius(C5_RADIUS, LO, HI) + 1)
    gt = {}
    tree, gt["octree_ms"] = sync_time(
        lambda: port.build_octree(pts, LO, HI, num_levels=levels, device=dev))
    cap = port.suggest_cell_capacity(tree, C5_RADIUS, LO, HI)
    edges, gt["radius_segments_ms"] = sync_time(lambda: port.radius_graph_cell_segments(
        tree, C5_RADIUS, LO, HI, max_neighbors=L2_NEIGHBORS, cell_capacity=cap,
        num_segments=C5_SEGMENTS, selection="sort"))
    approx2_phase(card, tree, cap, edges, gt["radius_segments_ms"])
    feats = rng.standard_normal((n, 5)).astype(np.float32)
    graph, gt["dense_graph_ms"] = sync_time(lambda: port.DenseEdgeGraph.from_radius_edges(
        feats, tree.points, edges, symmetrize=False))
    del tree, edges, pts, feats
    layers = NUM_LAYERS
    model = lmax2_model(dev, remat=True, remat_kernel=True, edge_chunks=C5_CHUNKS,
                        remat_layers=C5_REMAT_LAYERS)
    attrs, gt["attributes_ms"] = sync_time(lambda: model.compute_attributes_dense_chunked(
        graph.positions, graph.senders, graph.edge_mask, dtype=bf))
    n_edges = int(graph.edge_mask.sum())
    emit("graph_10m", points=n, radius=C5_RADIUS, k=L2_NEIGHBORS, cell_capacity=cap,
         octree_levels=levels, segments=C5_SEGMENTS, selection="sort", edges=n_edges,
         graph_build_ms=sum(gt.values()), card=card, **gt)
    check(n_edges > 0 and graph.reverse_slot is None, "the 10M graph")

    # ---- 25. the kernels at one node block's shapes, fp32 and bf16
    c = n // C5_CHUNKS
    tile = SEGNNLayer._pick_generic_tile(c)
    kern = fmg.FusedMessageGeneric(model.layers[0].message_layers, L2_NEIGHBORS, tile,
                                   residual_bwd=False)
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    h_ext = torch.randn((n, kern.config(9, 0).f), generator=gen, device=dev)
    chk = {}
    for dtype in (torch.float32, bf):
        cfg, args, n_valid = untabled_inputs(kern, graph.senders, attrs[3], h_ext, 0, c, dtype, gen)
        d_agg = torch.randn((c, cfg.out_dim), generator=gen, device=dev).to(dtype)
        chk[dtype] = untabled_check("config5_block", kern, cfg, args, n_valid, d_agg,
                                    times=dtype == bf)
        del cfg, args, d_agg
    del h_ext
    t = chk[bf]["times"]

    # ---- 26. the train step
    graph_bf = graph._replace(nodes=graph.nodes.to(bf))
    del graph
    target = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)).to(dev)
    per_step = layers * C5_CHUNKS
    want = expected({fmg.GENERIC_FWD.name: 3 * per_step, fmg.GENERIC_BWD_REP.name: per_step,
                     fmg.GENERIC_TAB_BWD_WGRAD.name: per_step, fm.TAB_BWD_REDUCE.name: per_step})
    step = train_run(model, graph_bf, attrs, target, C5_TRAIN_STEPS, card, "train_config5", want,
                     points=n, edges=n_edges, edge_chunks=C5_CHUNKS, block_tile=tile,
                     remat_layers=C5_REMAT_LAYERS, remat=True, remat_kernel=True,
                     backward="replay (#13)", selection="sort")
    launches = launch_counts()
    emit("config5", card=card, step_ms=step.step_ms[-1], warmup_step_ms=step.step_ms[0],
         graph_build_ms=sum(gt.values()), edges=n_edges,
         kernel_ms_per_step_estimate=dict(
             fwd=3 * per_step * t["fwd_ms"], rep=per_step * t["rep_ms"]))
    del step, model, graph_bf, attrs, target

    # ---- 27. fp32 gradients of the chunked, layer-group-checkpointed model
    pts = np.random.default_rng(SEED + 19).random((GC5_POINTS, 3)).astype(np.float32)
    lv = max(4, search_level_for_radius(GC5_RADIUS, LO, HI) + 1)
    tree = port.build_octree(pts, LO, HI, num_levels=lv, device=dev)
    cap = port.suggest_cell_capacity(tree, GC5_RADIUS, LO, HI)
    kw = dict(max_neighbors=L2_NEIGHBORS, cell_capacity=cap)
    e_seg = port.radius_graph_cell_segments(tree, GC5_RADIUS, LO, HI, num_segments=C5_SEGMENTS,
                                            **kw)
    feats = np.random.default_rng(SEED + 20).standard_normal((GC5_POINTS, 5)).astype(np.float32)
    g = port.DenseEdgeGraph.from_radius_edges(feats, tree.points, e_seg, symmetrize=False)
    t_gc = torch.from_numpy(np.random.default_rng(SEED + 21).standard_normal(
        (GC5_POINTS, 3)).astype(np.float32)).to(dev)
    m_p = lmax2_model(dev, use_pallas=False)
    attrs_gc = m_p.compute_attributes_dense_chunked(g.positions, g.senders, g.edge_mask,
                                                    dtype=torch.float32)
    loss_p = mse_loss(m_p(g, attrs=attrs_gc), t_gc)
    loss_p.backward()
    m_k = lmax2_model(dev, remat=True, remat_kernel=True, edge_chunks=GC5_CHUNKS,
                      remat_layers=C5_REMAT_LAYERS)
    m_k.load_state_dict(m_p.state_dict())
    reset_launches()
    loss_k = mse_loss(m_k(g, attrs=attrs_gc), t_gc)
    loss_k.backward()
    got = launch_counts()
    worst, worst_name = 0.0, ""
    for (nm, a), b in zip(m_k.named_parameters(), m_p.parameters(), strict=True):
        rel = float((a.grad - b.grad).abs().max()) / max(float(b.grad.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, nm
    gc_want = expected({fmg.GENERIC_FWD.name: 3 * layers * GC5_CHUNKS,
                        fmg.GENERIC_BWD_REP.name: layers * GC5_CHUNKS,
                        fmg.GENERIC_TAB_BWD_WGRAD.name: layers * GC5_CHUNKS,
                        fm.TAB_BWD_REDUCE.name: layers * GC5_CHUNKS})
    emit("grad_check_config5", points=GC5_POINTS, radius=GC5_RADIUS, k=L2_NEIGHBORS,
         edge_chunks=GC5_CHUNKS, remat_layers=C5_REMAT_LAYERS, dtype="float32",
         edges=int(g.edge_mask.sum()),
         loss_plain=loss_p.item(), loss_kernel=loss_k.item(), worst_param=worst_name,
         worst_rel_err=worst, launches=got,
         tolerance=f"{TOL_GRAD_FP32} * max|ref| per parameter; fp32 sums in another order")
    check(got == gc_want, f"gradient check launches {got}, expected {gc_want}")
    check(worst <= TOL_GRAD_FP32, f"config-5 fp32 gradients: {worst_name} off by {worst}")
    check(abs(loss_k.item() - loss_p.item()) <= 1e-5 * loss_p.item(), "losses differ (config 5)")
    del m_p, m_k, g, attrs_gc

    b = t["bounds"]
    common = dict(library_ms=None)
    return {
        fmg.GENERIC_FWD.name: dict(
            launches=launches[fmg.GENERIC_FWD.name], max_abs_err=chk[bf]["max_abs_err"]["fwd"],
            ms=t["fwd_ms"], plain_ms=t["fwd_plain_ms"], bound_ms=b["fwd"]["bound_ms"],
            bound_by=b["fwd"]["bound_by"], save_ms=t["save_ms"],
            device_ms=t["device_ms"]["fwd"], **common),
        fmg.GENERIC_BWD_REP.name: dict(
            launches=launches[fmg.GENERIC_BWD_REP.name], max_abs_err=chk[bf]["max_abs_err"]["rep"],
            ms=t["rep_ms"], plain_ms=t["rep_plain_ms"], bound_ms=b["rep"]["bound_ms"],
            bound_by=b["rep"]["bound_by"], chain_ms=t["rep_chain_ms"],
            wgrad_ms=t["rep_wgrad_ms"], chain_device_ms=t["device_ms"]["rep_chain"],
            wgrad_device_ms=t["device_ms"]["wgrad"], reduce_device_ms=t["device_ms"]["reduce"],
            **common),
    }


def km_model(dev, **kw):
    """Config 3's SEGNN (weights from the seed), on the untabled lmax=1 path."""
    return port.SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=NUM_LAYERS, layout="cm",
                      use_pallas=True, device=dev, generator=torch.Generator().manual_seed(SEED),
                      **kw)


def km_inputs(model, senders, edge_geo, h_ext, lo, hi, dtype, gen):
    """#3/#5's arguments for the receivers [lo, hi) of a graph, as the model
    hands them over: hs3 = h_ext[senders.T] (clamped) [K, hi-lo, F], the
    receivers' rows and the geometry with extra masked slots and a masked
    tail (the last 37 receivers without a valid slot), zero-padded to the km
    tile; layer 0's folded weights.  Returns (cfg, [hs3, hr, geo2], weights,
    valid slots)."""
    c, k = hi - lo, senders.shape[1]
    dev = senders.device
    layer = model.layers[0]
    tile = SEGNNLayer._pick_km_tile(c)
    npad = -(-c // tile) * tile
    cfg = fm.MessageConfig(hs=layer._pallas_hs, hv=layer._pallas_hv, k=k, tile=tile)
    geo = edge_geo[lo:hi].float().reshape(c, k, 6).clone()
    geo[..., 5] *= (torch.rand((c, k), generator=gen, device=dev) > 0.1).float()
    geo[c - 37:, :, 5] = 0.0
    n_valid = int((geo[..., 5] > 0).sum())
    f = cfg.f
    hs3 = h_ext[torch.clamp(senders[lo:hi].t(), max=h_ext.shape[0] - 1).long().contiguous()]
    pad = npad - c
    args = [torch.cat([hs3, hs3.new_zeros((k, pad, f))], dim=1),
            torch.cat([h_ext[lo:hi], h_ext.new_zeros((pad, f))]),
            torch.cat([geo.reshape(c, k * 6), geo.new_zeros((pad, k * 6))])]
    return cfg, [a.to(dtype).contiguous() for a in args], layer._folded_weights(dtype), n_valid


KM_OUTPUTS = (("d_hs", True), ("d_hr", True), ("dW0a", False), ("dW1Sa", False),
              ("dW1Va", False), ("dW0b", False), ("dW1Sb", False), ("dW1Vb", False))


# the untabled lmax=1 kernel forms: the kernels, and the names in
# kernels/fused_message.py of the forward wrapper, its plain version, the
# backward (main kernel and reduction), its main kernel and its plain version
# (looked up at call time)
LMAX1_FORMS = {
    "km": ((fm.KM_FWD, fm.KM_BWD), ("fused_message_aggregate_km_fwd",
            "fused_message_aggregate_km_plain", "km_bwd_kernels", "km_bwd_kernel",
            "km_bwd_plain")),
    "flat": ((fm.FLAT_FWD, fm.FLAT_BWD), ("fused_message_aggregate_fwd",
              "fused_message_aggregate_plain", "flat_bwd_kernels", "flat_bwd_kernel",
              "flat_bwd_plain")),
}


def km_check(label, cfg, args, ws, n_valid, d_agg, times: bool, form: str = "km") -> dict:
    """The forward and backward kernels of an untabled lmax=1 ``form`` (#3
    and #5, or #6 and #7; the backward's main kernel, then the reduction)
    against their plain versions on one set of inputs, two runs of each
    bitwise equal; with ``times``, CUDA-event times of each, of the
    backward's main kernel alone and of the plain versions, and the bounds.
    In bf16 the km d_hs is held to the exact-sum reference instead of the
    plain version (``km_d_hs_check``; its reading against the plain version
    beside).  Emits a ``kernel_<form>`` line."""
    kerns, names = LMAX1_FORMS[form]
    fwd, fwd_plain, bwd, bwd_main, bwd_plain = (getattr(fm, nm) for nm in names)
    hr = args[1]
    npad, k, f = hr.shape[0], cfg.k, cfg.f
    fp32 = hr.dtype == torch.float32
    ws6 = fm.split_weights(cfg, *ws)
    flat = lambda r: [r[0], r[1], *r[2]]
    with torch.no_grad():
        agg = fwd(cfg, *args, *ws)
        agg2 = fwd(cfg, *args, *ws)
        got = flat(bwd(cfg, *args, ws6, d_agg))
        again = flat(bwd(cfg, *args, ws6, d_agg))
        torch.cuda.synchronize()
        identical = torch.equal(agg, agg2) and all(torch.equal(x, y) for x, y in zip(got, again))
        del agg2, again
        cmp = {"agg": bwd_compare(agg, fwd_plain(cfg, *args, *ws), True, fp32,
                                  TOL_GENERIC_BF16_ULPS)}
        ref = flat(bwd_plain(cfg, *args, ws6, d_agg))
        for (nm, el), x, y in zip(KM_OUTPUTS, got, ref, strict=True):
            cmp[nm] = bwd_compare(x, y, el, fp32)
        if form == "km" and not fp32:
            vs_plain = cmp["d_hs"]
            cmp["d_hs"] = km_d_hs_check(cfg, args, ws6, d_agg, got[0], ref[0], bwd)
            cmp["d_hs"].update(max_abs_err=vs_plain["max_abs_err"],
                               max_abs_ref=vs_plain["max_abs_ref"], finite=vs_plain["finite"],
                               vs_plain={nm: vs_plain[nm] for nm in
                                         ("max_ulps", "share_over_1ulp", "over_ulps")})
            check(cmp["d_hs"]["planted_caught"],
                  f"{label}: a planted d_hs fault passed: {cmp['d_hs']['planted']}")
        del ref
        # slot validity [Npad, K] and d_hs node-major [Npad, K, F]
        if form == "km":
            mask = args[2].reshape(npad, k, 6)[..., 5]
            d_hs = got[0].transpose(0, 1)
        else:
            mask = args[4].reshape(npad, k)
            d_hs = got[0].reshape(npad, k, f)
        # the padded receivers and the masked tail carry no valid slot: exact zeros
        zero_rows = bool((agg[mask.sum(dim=1) == 0] == 0).all())
        zero_dhs = bool((d_hs[mask == 0] == 0).all())
        del d_hs
    readings = None if fp32 else {
        nm: dict(max=v["max_ulps"], share_over_1ulp=v["share_over_1ulp"]) for nm, v in cmp.items()}
    out = dict(label=label, dtype=str(hr.dtype).replace("torch.", ""), rows=npad, k=k,
               tile=cfg.tile, pack=cfg.pack, valid_slots=n_valid, compared=cmp,
               bf16_ulps=readings,
               bit_identical_reruns=identical, zero_rows_without_valid_slots=zero_rows,
               zero_d_hs_on_masked_slots=zero_dhs,
               max_abs_err=dict(fwd=cmp["agg"]["max_abs_err"],
                                bwd=max(cmp[nm]["max_abs_err"] for nm, _ in KM_OUTPUTS)))
    if times:
        with torch.no_grad():
            t = dict(
                fwd_ms=event_ms(lambda: fwd(cfg, *args, *ws), iters=10),
                fwd_plain_ms=event_ms(lambda: fwd_plain(cfg, *args, *ws), iters=2, warmup=1),
                bwd_ms=event_ms(lambda: bwd(cfg, *args, ws6, d_agg), iters=5, warmup=1),
                bwd_main_ms=event_ms(lambda: bwd_main(cfg, *args, ws6, d_agg), iters=5,
                                     warmup=1),
                bwd_plain_ms=event_ms(lambda: bwd_plain(cfg, *args, ws6, d_agg), iters=2,
                                      warmup=1))
        # bounds: each input read once, each output written once; the
        # multiply-adds of the valid slots (1 pass forward, 3 backward: the
        # recompute and the two VJP products) at the bf16 tensor-core peak
        flops = 2 * messages_per_slot(cfg) * n_valid
        io = nbytes(*args, *ws)
        dws = 4 * sum(a * b for a, b in cfg.weight_shapes())
        t["bounds"] = {k_: dict(zip(("bound_ms", "bound_by", "bytes_ms", "ops_ms"), v)) for k_, v in (
            ("fwd", bound(io + nbytes(agg), flops)),
            ("bwd", bound(io + nbytes(d_agg, got[0], got[1]) + dws, 3 * flops)))}
        t["mbytes"] = dict(fwd=(io + nbytes(agg)) / 1e6,
                           bwd=(io + nbytes(d_agg, got[0], got[1]) + dws) / 1e6)
        out["times"] = t
    emit(f"kernel_{form}", kernels=[kerns[0].name, kerns[1].name, fm.TAB_BWD_REDUCE.name], **out,
         tolerance=(f"{TOL_BWD_FP32} * max(1, |ref|) elementwise for agg, d_hs, d_hr; "
                    f"{TOL_BWD_FP32} * max|ref| for the weight blocks (fp32 sums in another "
                    "order)") if fp32 else
         (f"agg {TOL_GENERIC_BF16_ULPS}, the backward's outputs {TOL_GENERIC_BWD_BF16_ULPS} "
          "bf16 ulps of max(|ref|, mean|ref|) elementwise, and at most "
          f"{TOL_GENERIC_BWD_BF16_OVER_1ULP} of the elements over 1 ulp (kernel and plain "
          "version round at the same points; fp32 sums in another order flip a rounding now "
          "and then); km d_hs against the exact-sum reference instead, its limit the larger "
          f"of {TOL_GENERIC_BWD_BF16_ULPS} ulps and the plain version's own distance from "
          "it, two planted faults failing it; reruns bitwise"))
    bad = {nm: v for nm, v in cmp.items() if v["over"] or not v["finite"]}
    check(not bad, f"{label}: {form} kernels vs plain in {hr.dtype}: {bad}")
    check(identical and zero_rows and zero_dhs,
          f"{label}: reruns {identical}, zero rows {zero_rows}, zero masked d_hs {zero_dhs}")
    return out


def example_graph(n: int, dev):
    """``examples/train_pointcloud.py``'s cloud and graph at ``n`` points, at
    its defaults: points and masses from default_rng(0), r = 0.04 (1e5 /
    n)^(1/3), K=24, octree min(8, max(4, int(log2(1/r)))) levels, the cell
    capacity by suggest_cell_capacity, the cell radius graph, not
    symmetrized; node features [m, 1, 0, 0, 0] in Morton order; the target,
    the local mass dipole sum_j m_j (x_j - x_i).  Returns (graph, target,
    info, build ms)."""
    r = 0.04 * (100_000 / n) ** (1 / 3)
    rng = np.random.default_rng(0)
    pts = rng.random((n, 3)).astype(np.float32)
    masses = rng.random((n, 1)).astype(np.float32)
    levels = min(8, max(4, int(np.log2(1.0 / r))))
    t0 = time.perf_counter()
    tree = port.build_octree(pts, LO, HI, num_levels=levels, device=dev)
    cap = port.suggest_cell_capacity(tree, r, LO, HI)
    edges = port.radius_graph_cell(tree, r, LO, HI, max_neighbors=MAX_NEIGHBORS, cell_capacity=cap)
    ms = torch.from_numpy(masses).to(dev)[tree.order.long()]
    feats = torch.cat([ms, torch.ones_like(ms), torch.zeros((n, 3), device=dev)], dim=-1)
    graph = port.DenseEdgeGraph.from_radius_edges(feats, tree.points, edges)
    rel = graph.rel_positions()
    mj = ms[:, 0][torch.clamp(graph.senders, max=n - 1).long()]
    target = (rel * torch.where(graph.edge_mask, mj, 0.0)[..., None]).sum(dim=1)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    info = dict(points=n, radius=r, k=MAX_NEIGHBORS, octree_levels=levels, cell_capacity=cap,
                edges=int(graph.edge_mask.sum()), symmetrized=False,
                edge_chunks=max(1, n // EX_BLOCK))
    del tree, edges, rel, mj
    return graph, target, info, build_ms


def km_grad_check(dev, graph, pack: int = 1, **kw) -> dict:
    """fp32 gradients of every parameter of config 3's model through the
    untabled lmax=1 kernels (#3/#5; at ``pack`` > 1 #6/#7) against autograd
    through the plain message path on ``graph`` (no tables), and at pack > 1
    also against the same model at pack 1 (#3/#5), elementwise; ``kw``: the
    model's ladder settings.  Returns the readings and the launches of the
    kernel model's forward and backward."""
    models = {"kernel": km_model(dev, pack=pack, **kw),
              "plain": port.SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=NUM_LAYERS,
                                  layout="cm", use_pallas=False, device=dev)}
    if pack > 1:
        models["pack1"] = km_model(dev, **kw)
    for m in list(models.values())[1:]:
        m.load_state_dict(models["kernel"].state_dict())
    with torch.no_grad():
        attrs = models["kernel"].compute_attributes_dense(graph)
    n = graph.senders.shape[0]
    t_gc = torch.from_numpy(np.random.default_rng(SEED + 4).standard_normal(
        (n, 3)).astype(np.float32)).to(dev)
    out = {}
    for name, m in models.items():
        if name == "kernel":
            reset_launches()
        loss = mse_loss(m(graph, attrs=attrs), t_gc)
        loss.backward()
        out[f"loss_{name}"] = loss.item()
        if name == "kernel":
            out["launches"] = launch_counts()
    params = [list(m.named_parameters()) for m in models.values()]
    worst, worst_name, worst1, worst1_name = 0.0, "", 0.0, ""
    for (nm, a), (_, b), *rest in zip(*params, strict=True):
        rel = float((a.grad - b.grad).abs().max()) / max(float(b.grad.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, nm
        if rest:  # against pack 1: elementwise, TOL_PACK_VS_KM * max(1, |ref|)
            c = rest[0][1].grad
            err1 = float(((a.grad - c).abs() / c.abs().clamp(min=1.0)).max())
            if err1 > worst1:
                worst1, worst1_name = err1, nm
    out.update(worst_param=worst_name, worst_rel_err=worst)
    if pack > 1:
        out.update(worst_param_vs_pack1=worst1_name, worst_err_vs_pack1=worst1)
    return out


def km_phases(card: str, graph3) -> dict:
    """Phases 28-33: the untabled lmax=1 path (#3 forward, #5 backward with
    the fixed-order reduction), config 3's SEGNN (32x0e+16x1o, 4 layers, bf16 compute
    on fp32 masters, MSE, Adam 1e-3).

    28. kernel_km -- #3 and #5 against their plain versions at the 100k
        shapes (bench.py's symmetrized graph, tile 160) and at one 1M node
        block (125,000 receivers padded to 125,056, tile 64), fp32 and bf16,
        real senders, geometry and folded weights, extra masked slots.
    29. forward_km -- one config-3 forward on bench.py's 100k graph with its
        tables dropped (senders by take_dense_symmetric_km): exactly 4 of #3.
    30. train_km_100k -- 5 steps there: per step 4 of #3, 4 of #5 and 4
        reductions, none of #1/#2.
    31. train_km_example_100k -- examples/train_pointcloud.py at its defaults
        (100k points, not symmetrized: senders by gather_km, edge_chunks=1,
        remat): 3 counted steps, 4 of #3 and 4 of #5 each; a torch.profiler
        trace of two more.
    32. train_km_1m -- the example at --points 1000000 (edge_chunks=8,
        125,000-node blocks each padded to the km tile 64, remat): a warm-up
        and 2 more steps, all counted; per step, with L = 4 layers and C = 8
        blocks, each block checkpointed: #3 in the forward and again in the
        block's recompute, 2 L C = 64; #5 once per layer and block, L C = 32;
        peak memory; a torch.profiler trace of one more step.
    33. grad_check_km -- fp32 gradients through #3/#5 against autograd of
        the plain path at 20k points (GC_RADIUS): symmetrized without tables,
        and with edge_chunks=4 (remat; 5,000-node blocks padded to 5,056).
    Then km_times: the kernels' and the plain versions' times, the bounds,
    the untabled config-3 forward and step, the 1M step.  Returns the rows
    of #3 and #5 for the ``kernels`` line."""
    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    n = N_POINTS
    per_layer = lambda c: {fm.KM_FWD.name: NUM_LAYERS * c, fm.KM_BWD.name: NUM_LAYERS * c,
                           fm.TAB_BWD_REDUCE.name: NUM_LAYERS * c}
    g100 = graph3._replace(**NO_TABLES)
    model = km_model(dev)
    with torch.no_grad():
        attrs32 = model.compute_attributes_dense(g100)

    # ---- 28. the kernels at the 100k and the 1M block shapes
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    chk = {}
    h_ext = torch.randn((n, model.hidden_irreps.dim), generator=gen, device=dev)
    for dtype in (torch.float32, bf):
        cfg, args, ws, n_valid = km_inputs(model, g100.senders, attrs32[3], h_ext, 0, n, dtype,
                                           gen)
        check(args[1].shape[0] == n, f"100k: padded to {args[1].shape[0]} at tile {cfg.tile}")
        d_agg = torch.randn(args[1].shape, generator=gen, device=dev).to(dtype)
        chk[dtype] = km_check("config3_100k", cfg, args, ws, n_valid, d_agg, times=dtype == bf)
        del cfg, args, d_agg
    del h_ext
    g1m, y1m, info1m, build1m_ms = example_graph(L1M_POINTS, dev)
    c = L1M_POINTS // info1m["edge_chunks"]
    with torch.no_grad():
        attrs1m = model.compute_attributes_dense(g1m)
    h_ext = torch.randn((L1M_POINTS, model.hidden_irreps.dim), generator=gen, device=dev)
    cfg, args, ws, n_valid = km_inputs(model, g1m.senders, attrs1m[3], h_ext, 0, c, bf, gen)
    check(cfg.tile == 64 and args[1].shape[0] == -(-c // 64) * 64 > c,
          f"1M block: {args[1].shape[0]} rows at tile {cfg.tile}, not padded")
    d_agg = torch.randn(args[1].shape, generator=gen, device=dev).to(bf)
    chk["1m_block"] = km_check("example_1m_block", cfg, args, ws, n_valid, d_agg, times=False)
    del h_ext, cfg, args, d_agg, attrs1m

    # ---- 29. the config-3 forward without tables, counted
    model_bf = copy.deepcopy(model).to(bf)
    attrs_bf = tuple(a.to(bf) for a in attrs32)
    g_bf = g100._replace(nodes=g100.nodes.to(bf))
    check(g100.reverse_slot is not None and g100.gather_loc is None, "100k: not the sym graph")
    fwd = lambda: model_bf(g_bf, attrs=attrs_bf)
    with torch.no_grad():
        reset_launches()
        out = fwd()
        torch.cuda.synchronize()
        launches = launch_counts()
        check(launches == expected({fm.KM_FWD.name: NUM_LAYERS}),
              f"{launches} kernel launches in one untabled forward")
        check(tuple(out.shape) == (n, 3) and bool(torch.isfinite(out).all()),
              f"untabled forward: shape {tuple(out.shape)} or non-finite")
        state32 = {k_: v.float() for k_, v in model_bf.state_dict().items()}
        plain32 = port.SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=NUM_LAYERS, layout="cm",
                             use_pallas=False, device=dev)
        plain32.load_state_dict(state32)
        ref = plain32(g100, attrs=attrs32)
        model32 = km_model(dev)
        model32.load_state_dict(state32)
        k32 = model32(g100, attrs=attrs32)
        scale = float(ref.abs().max())
        err32 = float((k32 - ref).abs().max())
        errbf = float((out.float() - ref).abs().max())
        emit("forward_km", points=n, layers=NUM_LAYERS, dtype="bfloat16", tables=False,
             gather="take_dense_symmetric_km", shape=list(out.shape), launches=launches,
             max_abs_ref=scale, fp32_kernel_vs_plain_max_abs_err=err32,
             fp32_tolerance=f"{TOL_FORWARD_FP32} * max(1, |ref|); fp32 sums in another order",
             bf16_kernel_vs_fp32_plain_max_abs_err=errbf,
             bf16_tolerance=f"{TOL_FORWARD_BF16} * max|ref|; bf16 storage through 4 layers")
        check(bool(((k32 - ref).abs() <= TOL_FORWARD_FP32 * torch.clamp(ref.abs(), min=1.0)).all()),
              f"untabled fp32 forward: kernel vs plain max abs err {err32}")
        check(errbf <= TOL_FORWARD_BF16 * scale, f"untabled bf16 forward vs fp32 plain: {errbf}")
        del ref, k32, out, plain32, model32
        fwd_ms = event_ms(fwd, iters=10)

    # ---- 30. 5 train steps on the 100k graph without tables
    target = torch.from_numpy(np.random.default_rng(SEED + 2).standard_normal(
        (n, 3)).astype(np.float32)).to(dev)
    step = train_run(model, g_bf, attrs_bf, target, TRAIN_STEPS, card, "train_km_100k",
                     expected(per_layer(1)), hidden=HIDDEN, points=n, tables=False,
                     gather="take_dense_symmetric_km")
    launches_100k = launch_counts()
    step_ms = event_ms(lambda: step(g_bf, attrs_bf, target), iters=5, warmup=1)
    del step, model, model_bf, target, attrs_bf, attrs32, g_bf

    # ---- 31. the example at its defaults: 100k points, not symmetrized
    g_ex, y_ex, info_ex, build_ex_ms = example_graph(EX_POINTS, dev)
    model = km_model(dev, remat=True, edge_chunks=info_ex["edge_chunks"])
    check(info_ex["edge_chunks"] == 1 and g_ex.reverse_slot is None, "example 100k graph")
    with torch.no_grad():
        attrs = tuple(a.to(bf) for a in model.compute_attributes_dense(g_ex))
    gx_bf = g_ex._replace(nodes=g_ex.nodes.to(bf))
    step = train_run(model, gx_bf, attrs, y_ex, L2_TRAIN_STEPS, card, "train_km_example_100k",
                     expected(per_layer(1)), hidden=HIDDEN, remat=True, gather="gather_km",
                     graph_build_ms=build_ex_ms, **info_ex)
    step_ex_ms = step.step_ms[-1]
    prof_ex = profile_steps(step, (gx_bf, attrs, y_ex))
    emit("profile_km_example_100k", card=card, points=EX_POINTS, **prof_ex)
    check(prof_ex["device_ms_per_step"] > 0, "the profiler saw no device time")
    # the unsymmetrized sender gradient is an indexed scatter-add: are two
    # runs of it bitwise equal on the card?  (a reading, not a check)
    hx = torch.randn((EX_POINTS, model.hidden_irreps.dim), generator=gen, device=dev).to(bf)
    gx = torch.randn((MAX_NEIGHBORS, EX_POINTS, hx.shape[1]), generator=gen, device=dev).to(bf)
    grads = []
    for _ in range(2):
        hl = hx.clone().requires_grad_(True)
        gather_km(hl, g_ex.senders).backward(gx)
        grads.append(hl.grad)
    gather_grad_identical = torch.equal(grads[0], grads[1])
    del step, model, attrs, gx_bf, g_ex, y_ex, hx, gx, grads, hl

    # ---- 32. the example at 1M points: edge_chunks=8, padded blocks
    chunks = info1m["edge_chunks"]
    check(chunks == L1M_POINTS // EX_BLOCK == 8 and g1m.reverse_slot is None,
          f"1M example: {chunks} chunks")
    model = km_model(dev, remat=True, edge_chunks=chunks)
    with torch.no_grad():
        attrs = tuple(a.to(bf) for a in model.compute_attributes_dense(g1m))
    g1_bf = g1m._replace(nodes=g1m.nodes.to(bf))
    step = train_run(model, g1_bf, attrs, y1m, 1 + L1M_TRAIN_STEPS, card, "train_km_1m",
                     expected({fm.KM_FWD.name: 2 * NUM_LAYERS * chunks,
                               fm.KM_BWD.name: NUM_LAYERS * chunks,
                               fm.TAB_BWD_REDUCE.name: NUM_LAYERS * chunks}),
                     hidden=HIDDEN, remat=True, gather="gather_km", block_rows=c,
                     block_tile=SEGNNLayer._pick_km_tile(c), graph_build_ms=build1m_ms, **info1m)
    step_1m_ms = step.step_ms[1:]
    prof_1m = profile_steps(step, (g1_bf, attrs, y1m), steps=1)
    emit("profile_km_1m", card=card, points=L1M_POINTS, **prof_1m)
    del step, model, attrs, g1_bf, g1m, y1m

    # ---- 33. fp32 gradients through #3/#5 against the plain path, 20k points
    pts_gc = np.random.default_rng(SEED + 3).random((GC_POINTS, 3)).astype(np.float32)
    _, _, _, g_gc, _ = build_graph(pts_gc, GC_RADIUS)
    g_gc = g_gc._replace(**NO_TABLES)
    gc_chunks = 4
    for label, kw, want in (
            ("symmetrized", {}, per_layer(1)),
            ("edge_chunks", dict(remat=True, edge_chunks=gc_chunks),
             {fm.KM_FWD.name: 2 * NUM_LAYERS * gc_chunks, fm.KM_BWD.name: NUM_LAYERS * gc_chunks,
              fm.TAB_BWD_REDUCE.name: NUM_LAYERS * gc_chunks})):
        r = km_grad_check(dev, g_gc, **kw)
        c_gc = GC_POINTS // kw.get("edge_chunks", 1)
        emit("grad_check_km", case=label, points=GC_POINTS, radius=GC_RADIUS, k=MAX_NEIGHBORS,
             layers=NUM_LAYERS, dtype="float32", block_rows=c_gc,
             block_tile=SEGNNLayer._pick_km_tile(c_gc), edges=int(g_gc.edge_mask.sum()), **r,
             tolerance=f"{TOL_GRAD_FP32} * max|ref| per parameter; fp32 sums in another order")
        check(r["launches"] == expected(want), f"grad_check_km {label}: launches {r['launches']}")
        check(r["worst_rel_err"] <= TOL_GRAD_FP32,
              f"km fp32 gradients ({label}): {r['worst_param']} off by {r['worst_rel_err']}")
        check(abs(r["loss_kernel"] - r["loss_plain"]) <= 1e-5 * r["loss_plain"],
              f"km losses differ ({label})")
    del g_gc

    t = chk[bf]["times"]
    emit("km_times", card=card, points=n, forward_ms=fwd_ms, step_ms=step_ms,
         step_ms_example_100k=step_ex_ms, step_ms_1m=step_1m_ms,
         gather_km_grad_bit_identical_reruns=gather_grad_identical, kernels_100k=t,
         kernel_ms_per_step_100k=dict(fwd=NUM_LAYERS * t["fwd_ms"], bwd=NUM_LAYERS * t["bwd_ms"]))
    b = t["bounds"]
    return {
        fm.KM_FWD.name: dict(
            launches=launches_100k[fm.KM_FWD.name], max_abs_err=chk[bf]["max_abs_err"]["fwd"],
            ms=t["fwd_ms"], plain_ms=t["fwd_plain_ms"], bound_ms=b["fwd"]["bound_ms"],
            bound_by=b["fwd"]["bound_by"], library_ms=None),
        fm.KM_BWD.name: dict(
            launches=launches_100k[fm.KM_BWD.name], max_abs_err=chk[bf]["max_abs_err"]["bwd"],
            ms=t["bwd_ms"], plain_ms=t["bwd_plain_ms"], bound_ms=b["bwd"]["bound_ms"],
            bound_by=b["bwd"]["bound_by"], library_ms=None, main_kernel_ms=t["bwd_main_ms"]),
    }


PACKS = (2, 3, 4)  # tools/exp_pack.py's A/B: every p divides K = 24
PACK_MAIN = 2  # the pack of the counted forward and of the kernels line


def flat_inputs(model, senders, edge_geo, h_ext, lo, hi, p, dtype, gen):
    """#6/#7's arguments for the receivers [lo, hi) of a graph, as the model
    hands them over at pack p: hs = h_ext[senders] (clamped) reshaped to
    [Npad*K/p, p*F], the receivers' rows, d2, attr and maskf [Npad*K/p, .]
    with extra masked slots and a masked tail (the last 37 receivers without
    a valid slot), zero-padded to the km tile; layer 0's folded weights.
    Returns (cfg, [hs, hr, d2, attr, maskf], weights, valid slots)."""
    c, k = hi - lo, senders.shape[1]
    dev = senders.device
    layer = model.layers[0]
    tile = SEGNNLayer._pick_km_tile(c)
    npad = -(-c // tile) * tile
    cfg = fm.MessageConfig(hs=layer._pallas_hs, hv=layer._pallas_hv, k=k, tile=tile, pack=p)
    geo = edge_geo[lo:hi].float().reshape(c, k, 6).clone()
    geo[..., 5] *= (torch.rand((c, k), generator=gen, device=dev) > 0.1).float()
    geo[c - 37:, :, 5] = 0.0
    n_valid = int((geo[..., 5] > 0).sum())
    pad = lambda x: torch.cat([x, x.new_zeros((npad - c,) + x.shape[1:])])
    r = npad * k // p
    hs = pad(h_ext[torch.clamp(senders[lo:hi], max=h_ext.shape[0] - 1).long()])
    geo = pad(geo)
    args = [hs.reshape(r, p * cfg.f), pad(h_ext[lo:hi]), geo[..., 4].reshape(r, p),
            geo[..., :4].reshape(r, 4 * p), geo[..., 5].reshape(r, p)]
    return cfg, [a.to(dtype).contiguous() for a in args], layer._folded_weights(dtype), n_valid


def pack_phases(card: str, graph3) -> dict:
    """Phases 34-37: the packed lmax=1 path (``SEGNN(pack=p)``: #6 forward,
    #7 backward with the fixed-order reduction), config 3's SEGNN (32x0e+16x1o,
    4 layers, bf16 compute on fp32 masters, MSE, Adam 1e-3) on bench.py's 100k
    graph with its tables dropped, as tools/exp_pack.py runs it.

    34. kernel_flat -- #6 and #7 against their plain versions at the 100k
        shapes (tile 160) at p = 2 and 4 in fp32 and bf16, and at 99,990
        receivers (padded to 100,032 at the km tile 64) at p = 2 in bf16,
        real senders, geometry and folded weights, extra masked slots.
    35. forward_pack -- one config-3 forward at p = 2 (senders by
        take_dense_symmetric): exactly 4 of #6, none of #1 or #3.
    36. train_pack_100k -- 5 counted steps at each of p = 2, 3, 4: per step 4
        of #6, 4 of #7 and 4 reductions, none of #1, #2, #3, #5; the step
        times by CUDA events after a warm-up, beside the pack-1 (km) step
        timed in the same phase.
    37. grad_check_pack -- fp32 gradients at p = 2 through #6/#7 against
        autograd of the plain path (TOL_GRAD_FP32 * max|ref|) and against
        the pack-1 model through #3/#5 (TOL_PACK_VS_KM * max(1, |ref|)) at
        20k points (GC_RADIUS): symmetrized without tables, and with
        edge_chunks=4 (remat; 5,000-node blocks padded to 5,056).
    Then pack_times.  Returns the rows of #6 and #7 for the ``kernels`` line."""
    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    n = N_POINTS
    per_layer = lambda c: {fm.FLAT_FWD.name: NUM_LAYERS * c, fm.FLAT_BWD.name: NUM_LAYERS * c,
                           fm.TAB_BWD_REDUCE.name: NUM_LAYERS * c}
    g100 = graph3._replace(**NO_TABLES)
    model = km_model(dev, pack=PACK_MAIN)
    with torch.no_grad():
        attrs32 = model.compute_attributes_dense(g100)

    # ---- 34. the kernels at the 100k shapes, and one padded case
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    chk = {}
    h_ext = torch.randn((n, model.hidden_irreps.dim), generator=gen, device=dev)
    for p, dtype, hi in ((2, torch.float32, n), (2, bf, n), (4, torch.float32, n), (4, bf, n),
                         (2, bf, n - 10)):
        cfg, args, ws, n_valid = flat_inputs(model, g100.senders, attrs32[3], h_ext, 0, hi, p,
                                             dtype, gen)
        check((args[1].shape[0] == n and cfg.tile == TILE) if hi == n else
              (cfg.tile == 64 and args[1].shape[0] == -(-hi // 64) * 64 > hi),
              f"{hi} receivers: {args[1].shape[0]} rows at tile {cfg.tile}")
        d_agg = torch.randn(args[1].shape, generator=gen, device=dev).to(dtype)
        label = f"config3_100k_p{p}" if hi == n else f"config3_{hi}_padded_p{p}"
        chk[(p, dtype, hi)] = km_check(label, cfg, args, ws, n_valid, d_agg,
                                       times=dtype == bf and hi == n, form="flat")
        del cfg, args, d_agg
    del h_ext

    # ---- 35. the config-3 forward at p = 2, counted
    model_bf = copy.deepcopy(model).to(bf)
    attrs_bf = tuple(a.to(bf) for a in attrs32)
    g_bf = g100._replace(nodes=g100.nodes.to(bf))
    check(g100.reverse_slot is not None and g100.gather_loc is None, "100k: not the sym graph")
    fwd = lambda: model_bf(g_bf, attrs=attrs_bf)
    with torch.no_grad():
        reset_launches()
        out = fwd()
        torch.cuda.synchronize()
        launches = launch_counts()
        check(launches == expected({fm.FLAT_FWD.name: NUM_LAYERS}),
              f"{launches} kernel launches in one packed forward")
        check(tuple(out.shape) == (n, 3) and bool(torch.isfinite(out).all()),
              f"packed forward: shape {tuple(out.shape)} or non-finite")
        state32 = {k_: v.float() for k_, v in model_bf.state_dict().items()}
        plain32 = port.SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=NUM_LAYERS, layout="cm",
                             use_pallas=False, device=dev)
        plain32.load_state_dict(state32)
        ref = plain32(g100, attrs=attrs32)
        model32 = km_model(dev, pack=PACK_MAIN)
        model32.load_state_dict(state32)
        k32 = model32(g100, attrs=attrs32)
        scale = float(ref.abs().max())
        err32 = float((k32 - ref).abs().max())
        errbf = float((out.float() - ref).abs().max())
        emit("forward_pack", points=n, layers=NUM_LAYERS, pack=PACK_MAIN, dtype="bfloat16",
             tables=False, gather="take_dense_symmetric", shape=list(out.shape),
             launches=launches, max_abs_ref=scale, fp32_kernel_vs_plain_max_abs_err=err32,
             fp32_tolerance=f"{TOL_FORWARD_FP32} * max(1, |ref|); fp32 sums in another order",
             bf16_kernel_vs_fp32_plain_max_abs_err=errbf,
             bf16_tolerance=f"{TOL_FORWARD_BF16} * max|ref|; bf16 storage through 4 layers")
        check(bool(((k32 - ref).abs() <= TOL_FORWARD_FP32 * torch.clamp(ref.abs(), min=1.0)).all()),
              f"packed fp32 forward: kernel vs plain max abs err {err32}")
        check(errbf <= TOL_FORWARD_BF16 * scale, f"packed bf16 forward vs fp32 plain: {errbf}")
        del ref, k32, out, plain32, model32
        fwd_ms = event_ms(fwd, iters=10)
    del model_bf

    # ---- 36. 5 counted train steps at each pack, and the pack-1 step beside them
    target = torch.from_numpy(np.random.default_rng(SEED + 2).standard_normal(
        (n, 3)).astype(np.float32)).to(dev)
    step_ms, launches_main = {}, None
    for p in PACKS:
        m = km_model(dev, pack=p)
        step = train_run(m, g_bf, attrs_bf, target, TRAIN_STEPS, card, "train_pack_100k",
                         expected(per_layer(1)), hidden=HIDDEN, points=n, pack=p, tables=False,
                         gather="take_dense_symmetric")
        if p == PACK_MAIN:
            launches_main = launch_counts()
        step_ms[p] = event_ms(lambda: step(g_bf, attrs_bf, target), iters=5, warmup=1)
        del step, m
    m = km_model(dev)
    opt = torch.optim.Adam(m.parameters(), lr=LEARNING_RATE, betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(m, bf16_loss, opt)
    step_ms[1] = event_ms(lambda: step(g_bf, attrs_bf, target), iters=5, warmup=1)
    del step, m, opt, model, attrs_bf, g_bf, target

    # ---- 37. fp32 gradients at p = 2 against the plain path and pack 1, 20k points
    pts_gc = np.random.default_rng(SEED + 3).random((GC_POINTS, 3)).astype(np.float32)
    _, _, _, g_gc, _ = build_graph(pts_gc, GC_RADIUS)
    g_gc = g_gc._replace(**NO_TABLES)
    gc_chunks = 4
    for label, kw, want in (
            ("symmetrized", {}, per_layer(1)),
            ("edge_chunks", dict(remat=True, edge_chunks=gc_chunks),
             {fm.FLAT_FWD.name: 2 * NUM_LAYERS * gc_chunks,
              fm.FLAT_BWD.name: NUM_LAYERS * gc_chunks,
              fm.TAB_BWD_REDUCE.name: NUM_LAYERS * gc_chunks})):
        r = km_grad_check(dev, g_gc, pack=PACK_MAIN, **kw)
        c_gc = GC_POINTS // kw.get("edge_chunks", 1)
        emit("grad_check_pack", case=label, points=GC_POINTS, radius=GC_RADIUS, k=MAX_NEIGHBORS,
             layers=NUM_LAYERS, pack=PACK_MAIN, dtype="float32", block_rows=c_gc,
             block_tile=SEGNNLayer._pick_km_tile(c_gc), edges=int(g_gc.edge_mask.sum()), **r,
             tolerance=(f"vs plain {TOL_GRAD_FP32} * max|ref| per parameter; vs pack 1 "
                        f"{TOL_PACK_VS_KM} * max(1, |ref|) elementwise; fp32 sums in another "
                        "order"))
        check(r["launches"] == expected(want), f"grad_check_pack {label}: launches {r['launches']}")
        check(r["worst_rel_err"] <= TOL_GRAD_FP32,
              f"packed fp32 gradients ({label}): {r['worst_param']} off by {r['worst_rel_err']}")
        check(r["worst_err_vs_pack1"] <= TOL_PACK_VS_KM,
              f"packed vs pack-1 gradients ({label}): {r['worst_param_vs_pack1']} off by "
              f"{r['worst_err_vs_pack1']}")
        check(abs(r["loss_kernel"] - r["loss_plain"]) <= 1e-5 * r["loss_plain"],
              f"packed losses differ ({label})")
    del g_gc

    t = chk[(PACK_MAIN, bf, n)]["times"]
    t4 = chk[(4, bf, n)]["times"]
    emit("pack_times", card=card, points=n, forward_ms_p2=fwd_ms,
         step_ms={f"pack_{p}": v for p, v in step_ms.items()},
         kernels_100k_p2=t, kernels_100k_p4=t4,
         kernel_ms_per_step_100k_p2=dict(fwd=NUM_LAYERS * t["fwd_ms"],
                                         bwd=NUM_LAYERS * t["bwd_ms"]))
    b = t["bounds"]
    return {
        fm.FLAT_FWD.name: dict(
            launches=launches_main[fm.FLAT_FWD.name],
            max_abs_err=chk[(PACK_MAIN, bf, n)]["max_abs_err"]["fwd"], ms=t["fwd_ms"],
            plain_ms=t["fwd_plain_ms"], bound_ms=b["fwd"]["bound_ms"],
            bound_by=b["fwd"]["bound_by"], library_ms=None, pack=PACK_MAIN),
        fm.FLAT_BWD.name: dict(
            launches=launches_main[fm.FLAT_BWD.name],
            max_abs_err=chk[(PACK_MAIN, bf, n)]["max_abs_err"]["bwd"], ms=t["bwd_ms"],
            plain_ms=t["bwd_plain_ms"], bound_ms=b["bwd"]["bound_ms"],
            bound_by=b["bwd"]["bound_by"], library_ms=None, main_kernel_ms=t["bwd_main_ms"],
            pack=PACK_MAIN),
    }


VJP_TILES = (200, 80)  # #14's backward tiles: the 250k step's (= the tile) and under
#                        remat_kernel at 1M (the largest of 80, 64, ... dividing N)
SPARSE_LMAX_ATTR = 5  # attributes 36 wide: non-foldable message layers


def vjp_graph(dev):
    """tools/exp_residual_bwd.py's graph: 250k uniform points, their features
    and the target from one default_rng(0), 7 octree levels, r = 0.04 *
    (100000/250000)^(1/3), K=16, the suggested cell capacity, symmetrized, no
    gather tables.  Returns (graph, target, cell capacity, times)."""
    rng = np.random.default_rng(0)
    pts = rng.random((L2_POINTS, 3)).astype(np.float32)
    t = {}
    tree, t["octree_ms"] = sync_time(
        lambda: port.build_octree(pts, LO, HI, num_levels=L2_OCTREE_LEVELS, device=dev))
    cap = port.suggest_cell_capacity(tree, L2_RADIUS, LO, HI)
    edges, t["radius_graph_ms"] = sync_time(
        lambda: port.radius_graph_cell(tree, L2_RADIUS, LO, HI, max_neighbors=L2_NEIGHBORS,
                                       cell_capacity=cap))
    feats = rng.standard_normal((L2_POINTS, 5)).astype(np.float32)
    graph, t["symmetrize_ms"] = sync_time(
        lambda: port.DenseEdgeGraph.from_radius_edges(feats, tree.points, edges,
                                                      symmetrize=True))
    target = torch.from_numpy(rng.standard_normal((L2_POINTS, 3)).astype(np.float32)).to(dev)
    return graph, target, cap, t


def vjp_launches(model, n: int, tile: int) -> dict:
    """#14's launches per train step of ``model`` on n receivers: per message
    layer one chain, and one weight-gradient launch and one reduction per group
    of backward tiles (``fmg.vjp_group``)."""
    kern = fmg.FusedMessageGeneric(model.layers[0].message_layers, L2_NEIGHBORS, tile)
    cfg = kern.config(model.attr_irreps.dim, 0)
    ntiles = n // model.layers[0]._pick_bwd_tile(n)
    groups = -(-ntiles // fmg.vjp_group(cfg, ntiles))
    return {fmg.GENERIC_BWD_VJP.name: NUM_LAYERS,
            fmg.GENERIC_BWD_VJP_WGRAD.name: NUM_LAYERS * groups,
            fm.TAB_BWD_REDUCE.name: NUM_LAYERS * groups}


def vjp_check(label, kern, cfg, args, n_valid, d_agg, bwd_tile: int, times: bool) -> dict:
    """#14 whole (the vjp chain, the per-tile weight-gradient kernel, the
    reduction) against its plain version on one set of inputs; two runs
    bitwise equal.  With ``times``, CUDA-event times of #14, of its chain, of
    one weight-gradient launch (a group of tiles) and of their plain versions,
    and the bounds.  Emits a ``kernel_vjp`` line; returns its numbers."""
    fp32 = args[1].dtype == torch.float32
    hs, h, geo2, ws, sels = args
    flat = lambda r: [r[0], r[1], *r[2]]
    with torch.no_grad():
        got = flat(fmg.generic_bwd_vjp_kernels(cfg, *args, d_agg, bwd_tile))
        again = flat(fmg.generic_bwd_vjp_kernels(cfg, *args, d_agg, bwd_tile))
        torch.cuda.synchronize()
        identical = all(torch.equal(x, y) for x, y in zip(got, again))
        del again
        ref = flat(fmg.generic_bwd_vjp_plain(cfg, *args, d_agg, bwd_tile))
        cmp = {nm: bwd_compare(x, y, el, fp32) for (nm, el), x, y in zip(UNTAB_OUTPUTS, got, ref)}
        c = cmp["d_hs"]
        if not fp32 and c["over_ulps"]:
            c["explained"] = explain_d_hs(cfg, args, d_agg, None, got[0], ref[0], vjp=True)
            c["over"] = c["explained"]["unexplained"] + int(
                c["share_over_1ulp"] > TOL_GENERIC_BWD_BF16_OVER_1ULP)
        del ref
    n, k = h.shape[0], cfg.k
    ntiles = n // bwd_tile
    out = dict(label=label, dtype=str(h.dtype).replace("torch.", ""), rows=n, k=k, a=cfg.a,
               bwd_tile=bwd_tile, tiles=ntiles, group=fmg.vjp_group(cfg, ntiles),
               valid_slots=n_valid, compared=cmp, bit_identical_reruns=identical,
               max_abs_err=max(v["max_abs_err"] for v in cmp.values()))
    if times:
        g = out["group"]
        with torch.no_grad():
            rows = fmg.generic_bwd_chain(cfg, *args, d_agg, vjp=True)[2:]
            t = dict(
                ms=event_ms(lambda: fmg.generic_bwd_vjp_kernels(cfg, *args, d_agg, bwd_tile),
                            iters=3, warmup=1),
                chain_ms=event_ms(lambda: fmg.generic_bwd_chain(cfg, *args, d_agg, vjp=True),
                                  iters=3, warmup=1),
                wgrad_ms=event_ms(lambda: fmg.generic_bwd_vjp_wgrad(
                    cfg, geo2, *rows, bwd_tile * k, 0, g), iters=3, warmup=1),
                plain_ms=event_ms(lambda: fmg.generic_bwd_vjp_plain(cfg, *args, d_agg, bwd_tile),
                                  iters=1, warmup=1),
                wgrad_plain_ms=event_ms(lambda: fmg.generic_bwd_vjp_wgrad_plain(
                    cfg, geo2, *rows, bwd_tile * k, 0, g), iters=1, warmup=1))
        # bounds: each input read once, each output written once; #14 whole
        # makes 3 passes of the folded weights' nonzeros per valid slot (the
        # replay, dm, dW'), as #13; its chain 2 (the replay, dm) against the
        # rows it writes for the weight gradients; one weight-gradient launch
        # one pass over the valid slots of its tiles against their rows and
        # its partials
        fps = kern.flops_per_slot()
        wsz = nbytes(*ws, *sels)
        dws = 4 * sum(w.numel() for w in ws)
        a = cfg.a
        valid_g = int((geo2[:g * bwd_tile].reshape(g * bwd_tile, k, a + 2)[..., a + 1] > 0).sum())
        row_bytes = lambda x, r: x[:r].numel() * x.element_size()
        t["bounds"] = {k_: dict(zip(("bound_ms", "bound_by", "bytes_ms", "ops_ms"), v)) for k_, v in (
            ("whole", bound(nbytes(hs, h, geo2, d_agg, got[0], got[1]) + wsz + dws,
                            3 * fps * n_valid)),
            ("chain", bound(nbytes(hs, h, geo2, d_agg, got[0], got[1], *rows) + wsz,
                            2 * fps * n_valid)),
            ("wgrad", bound(sum(row_bytes(x, g * bwd_tile * k) for x in rows) +
                            row_bytes(geo2, g * bwd_tile) + g * dws, fps * valid_g)))}
        t["valid_slots_group"] = valid_g
        out["times"] = t
        del rows
    emit("kernel_vjp", kernels=[fmg.GENERIC_BWD_VJP.name, fmg.GENERIC_BWD_VJP_WGRAD.name,
                                fm.TAB_BWD_REDUCE.name], **out,
         tolerance=(f"{TOL_BWD_FP32} * max(1, |ref|) elementwise for d_hs, d_hr; "
                    f"{TOL_BWD_FP32} * max|ref| for dW' (fp32 sums in another order)") if fp32 else
         (f"{TOL_GENERIC_BWD_BF16_ULPS} bf16 ulps of max(|ref|, mean|ref|) elementwise and at "
          f"most {TOL_GENERIC_BWD_BF16_OVER_1ULP} of the elements over 1 ulp (kernel and plain "
          "version round at the same points); a d_hs element over the limit passes only if "
          "#14's plain last stage fed the kernel's dy_1 of its slot row gives the kernel's row "
          f"within {TOL_FLIP_REFED_ULPS} ulp; reruns bitwise"))
    bad = {nm: v for nm, v in cmp.items() if v["over"] or not v["finite"]}
    check(not bad, f"{label}: #14 vs plain in {h.dtype} at bwd_tile {bwd_tile}: {bad}")
    check(identical, f"{label}: two runs of #14 differ")
    return out


def vjp_grad_check(dev, lmax_attr: int) -> dict:
    """fp32 gradients of every parameter through #11/#14 at GC2_POINTS (the
    250k density, no tables) against autograd through the plain path, and
    at lmax_attr=2 also against the replay backward (#13) elementwise."""
    pts = np.random.default_rng(SEED + 40).random((GC2_POINTS, 3)).astype(np.float32)
    levels = max(4, search_level_for_radius(GC2_RADIUS, LO, HI) + 1)
    _, _, _, g_gc, _ = build_graph(pts, radius=GC2_RADIUS, levels=levels, k=L2_NEIGHBORS,
                                   tile=SEGNNLayer._pick_generic_tile(GC2_POINTS))
    g_gc = g_gc._replace(**NO_TABLES)
    t_gc = torch.from_numpy(np.random.default_rng(SEED + 41).standard_normal(
        (GC2_POINTS, 3)).astype(np.float32)).to(dev)
    mk = lambda use_pallas, **kw: port.SEGNN(
        "2x0e+1x1o", L2_HIDDEN, "1x1o", lmax_attr=lmax_attr, num_layers=NUM_LAYERS, layout="cm",
        use_pallas=use_pallas, device=dev, generator=torch.Generator().manual_seed(SEED), **kw)
    m_p = mk(False)
    attrs = geo_only(m_p, g_gc, torch.float32)
    loss_p = mse_loss(m_p(g_gc, attrs=attrs), t_gc)
    loss_p.backward()
    ref = {nm: p.grad for nm, p in m_p.named_parameters()}
    legs = {"vjp": (dict(remat=True, residual_bwd=False, replay_bwd=False), fmg.GENERIC_BWD_VJP)}
    if lmax_attr == 2:
        legs["replay"] = (dict(remat=True, residual_bwd=False), fmg.GENERIC_BWD_REP)
    out, grads = {}, {}
    for leg, (kw, kern_) in legs.items():
        m_k = mk(True, **kw)
        before = kern_.launches
        loss_k = mse_loss(m_k(g_gc, attrs=attrs), t_gc)
        loss_k.backward()
        grads[leg] = {nm: p.grad for nm, p in m_k.named_parameters()}
        worst, worst_name = 0.0, ""
        for nm, gr in grads[leg].items():
            rel = float((gr - ref[nm]).abs().max()) / max(float(ref[nm].abs().max()), 1e-30)
            if rel > worst:
                worst, worst_name = rel, nm
        out[leg] = dict(loss_kernel=loss_k.item(), worst_param=worst_name, worst_rel_err=worst,
                        launches=kern_.launches - before)
        check(kern_.launches - before == NUM_LAYERS, f"gradient check {leg}: {kern_.name}")
        check(worst <= TOL_GRAD_FP32, f"fp32 gradients ({leg}): {worst_name} off by {worst}")
        check(abs(loss_k.item() - loss_p.item()) <= 1e-5 * loss_p.item(), f"losses ({leg})")
        del m_k, loss_k
    if "replay" in grads:
        worst = max(float(((grads["vjp"][nm] - gr).abs() / gr.abs().clamp(min=1.0)).max())
                    for nm, gr in grads["replay"].items())
        out["vjp_vs_replay_worst"] = worst
        check(worst <= TOL_PACK_VS_KM, f"#14 vs #13 fp32 gradients: {worst}")
    return dict(points=GC2_POINTS, lmax_attr=lmax_attr, edges_symmetrized=int(
        g_gc.edge_mask.sum()), loss_plain=loss_p.item(), legs=out)


def vjp_phases(card: str, ctx: dict) -> dict:
    """Phases 38-43: the fallback backward #14 (``replay_bwd=False``, and the
    non-foldable message layers of ``lmax_attr=5``).  Returns the ``kernels``
    rows of #14, its weight-gradient kernel and #11's A=36 instance.

    38. graph_vjp, train_vjp_250k -- tools/exp_residual_bwd.py's A/B on its
        250k graph (no tables), bf16, ``remat``: the three generic backwards
        in one phase, each 3 counted steps and a timed step: replay_bwd=False
        (4 of #11 and 4 of #14 per step, #14's weight-gradient kernel and the
        reduction once per group of tiles), replay (#11, #13) and residual
        (#11 save, #12); none of #8-#10 in any.
    39. kernel_vjp -- #14 against its plain version at those shapes in fp32
        and bf16, at backward tiles 200 and 80; times at 200 (bf16).
    40. train_vjp_1m -- the 1M ``remat_kernel`` step with replay_bwd=False on
        the 1M graph without tables: the checkpoint replays #11 (8 per step),
        4 of #14 at backward tile 80.
    41. grad_check_vjp -- fp32 gradients through #11/#14 at 20k points
        against the plain path and against #13 (1e-5 * max(1, |ref|)).
    42. forward_sparse, train_sparse -- the lmax_attr=5 model (the lmax=2
        config's widths; message layers off the folded-GEMM path) on the
        250k graph: a counted bf16 forward (4 of #11) and 3 counted steps
        (4 of #11, 4 of #14); peak memory.
    43. kernel_sparse, grad_check_sparse -- #11 and #14 at A=36 against their
        plain versions at the 250k shapes (bf16); fp32 gradients of the
        lmax_attr=5 model at 20k points against the plain path."""
    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    n = L2_POINTS
    tile = SEGNNLayer._pick_generic_tile(n)
    # ---- 38. the graph and the A/B
    graph, target, cap, gtimes = vjp_graph(dev)
    emit("graph_vjp", points=n, radius=L2_RADIUS, k=L2_NEIGHBORS, cell_capacity=cap,
         octree_levels=L2_OCTREE_LEVELS, edges_symmetrized=int(graph.edge_mask.sum()),
         tables=False, card=card, graph_build_ms=sum(gtimes.values()), **gtimes)
    g_bf = graph._replace(nodes=graph.nodes.to(bf))
    fwd4 = {fmg.GENERIC_FWD.name: NUM_LAYERS}
    red4 = {fmg.GENERIC_TAB_BWD_WGRAD.name: NUM_LAYERS, fm.TAB_BWD_REDUCE.name: NUM_LAYERS}
    legs = (("replay_bwd=False (#14)", dict(residual_bwd=False, replay_bwd=False), None),
            ("replay (#13)", dict(residual_bwd=False), {fmg.GENERIC_BWD_REP.name: NUM_LAYERS}),
            ("residual (#12)", {}, {fmg.GENERIC_BWD_RES.name: NUM_LAYERS}))
    ab, launches_vjp, kern = {}, None, None
    for leg, kw, bwd in legs:
        model = lmax2_model(dev, remat=True, **kw)
        check(not any(layer._tab_eligible(n, graph) or layer._sym_regather_eligible(n, True)
                      for layer in model.layers), f"{leg}: not the untabled path")
        attrs_bf = geo_only(model, graph, bf)
        want = expected({**fwd4, **(vjp_launches(model, n, tile) if bwd is None
                                    else {**bwd, **red4})})
        step = train_run(model, g_bf, attrs_bf, target, L2_TRAIN_STEPS, card, "train_vjp_250k",
                         want, points=n, leg=leg, backward_tile=model.layers[0]._pick_bwd_tile(n),
                         remat=True, tables=False)
        if bwd is None:
            launches_vjp = launch_counts()
            kern = fmg.FusedMessageGeneric(model.layers[0].message_layers, L2_NEIGHBORS, tile,
                                           residual_bwd=False, replay_bwd=False)
        ab[leg] = dict(step_ms=event_ms(lambda: step(g_bf, attrs_bf, target), iters=2, warmup=0),
                       step_ms_counted=step.step_ms)
        del step, model
    emit("train_vjp_250k_ab", card=card, points=n, steps=ab,
         tool="tools/exp_residual_bwd.py: (residual_bwd, replay_bwd) = (False, False), "
              "(False, True), (True, True)")
    # ---- 39. #14 against its plain version at the 250k shapes
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    kv = {}
    for dtype in (torch.float32, bf):
        h_ext = torch.randn((n, kern.config(9, 0).f), generator=gen, device=dev)
        cfg, args, n_valid = untabled_inputs(kern, graph.senders, attrs_bf[3], h_ext, 0, n,
                                             dtype, gen)
        del h_ext
        d_agg = torch.randn((n, cfg.out_dim), generator=gen, device=dev).to(dtype)
        for bt in VJP_TILES:
            kv[(dtype, bt)] = vjp_check("vjp_250k", kern, cfg, args, n_valid, d_agg, bt,
                                        times=dtype == bf and bt == VJP_TILES[0])
        del cfg, args, d_agg
    t14 = kv[(bf, VJP_TILES[0])]["times"]
    # ---- 40. the 1M remat_kernel step with replay_bwd=False
    n1 = L1M_POINTS
    g1m = ctx.pop("g1m_untabled")
    model = lmax2_model(dev, remat=True, remat_kernel=True, replay_bwd=False)
    layer = model.layers[0]
    check(layer._pick_bwd_tile(n1) == VJP_TILES[1] and not layer._tab_eligible(n1, g1m)
          and not layer._sym_regather_eligible(n1, True), "1M: not #14 at backward tile 80")
    attrs1 = geo_only(model, g1m, bf)
    g1_bf = g1m._replace(nodes=g1m.nodes.to(bf))
    target1 = torch.from_numpy(np.random.default_rng(SEED + 43).standard_normal(
        (n1, 3)).astype(np.float32)).to(dev)
    want = expected({fmg.GENERIC_FWD.name: 2 * NUM_LAYERS,
                     **vjp_launches(model, n1, SEGNNLayer._pick_generic_tile(n1))})
    step = train_run(model, g1_bf, attrs1, target1, L1M_TRAIN_STEPS, card, "train_vjp_1m", want,
                     points=n1, backward_tile=VJP_TILES[1], remat=True, remat_kernel=True,
                     tables=False)
    step_ms_1m = step.step_ms[-1]
    del step, model, g1_bf, attrs1, g1m, target1
    # ---- 41. fp32 gradients through #14
    gc = vjp_grad_check(dev, 2)
    emit("grad_check_vjp", **gc, tolerance=(
        f"{TOL_GRAD_FP32} * max|ref| per parameter against the plain path; #14 against #13 "
        f"{TOL_PACK_VS_KM} * max(1, |ref|) elementwise (fp32: every rounding of #14 is the "
        "identity, sums in another order)"))
    # ---- 42. the lmax_attr=5 model: forward and train step
    model = port.SEGNN("2x0e+1x1o", L2_HIDDEN, "1x1o", lmax_attr=SPARSE_LMAX_ATTR,
                       num_layers=NUM_LAYERS, layout="cm", use_pallas=True, device=dev,
                       generator=torch.Generator().manual_seed(SEED))
    layer = model.layers[0]
    check(not layer.message_layers[0].tp._gemm_default() and layer.use_pallas_generic,
          "lmax_attr=5: the message layers are on the folded-GEMM path")
    attrs5 = geo_only(model, graph, bf)
    p_bf = {nm: w.to(bf) for nm, w in model.named_parameters()}
    fwd5 = lambda: torch.func.functional_call(model, p_bf, (g_bf,), {"attrs": attrs5})
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out5 = fwd5()
        torch.cuda.synchronize()
        fwd_launches = launch_counts()
        fwd_peak = torch.cuda.max_memory_allocated() / 1e9
        fwd5_ms = event_ms(fwd5, iters=2, warmup=1)
    emit("forward_sparse", points=n, lmax_attr=SPARSE_LMAX_ATTR, attr_width=model.attr_irreps.dim,
         layers=NUM_LAYERS, dtype="bfloat16", shape=list(out5.shape), launches=fwd_launches,
         finite=bool(torch.isfinite(out5).all()), forward_ms=fwd5_ms, peak_mem_gb=fwd_peak,
         card=card)
    check(fwd_launches == expected(fwd4), f"lmax_attr=5 forward launches {fwd_launches}")
    check(tuple(out5.shape) == (n, 3) and bool(torch.isfinite(out5).all()),
          "lmax_attr=5 forward: shape or finite")
    del out5, p_bf
    want = expected({**fwd4, **vjp_launches(model, n, tile)})
    step = train_run(model, g_bf, attrs5, target, L2_TRAIN_STEPS, card, "train_sparse", want,
                     points=n, lmax_attr=SPARSE_LMAX_ATTR, backward="#14 (non-foldable layers)",
                     tables=False)
    launches5 = launch_counts()
    step5_ms = event_ms(lambda: step(g_bf, attrs5, target), iters=1, warmup=0)
    kern5 = fmg.FusedMessageGeneric(layer.message_layers, L2_NEIGHBORS, tile)
    del step, model
    # ---- 43. #11 and #14 at A=36 against their plain versions; fp32 gradients
    h_ext = torch.randn((n, kern5.config(36, 0).f), generator=gen, device=dev)
    cfg5, args5, n_valid5 = untabled_inputs(kern5, graph.senders, attrs5[3], h_ext, 0, n, bf, gen)
    del h_ext
    with torch.no_grad():
        agg = fmg.generic_fwd(cfg5, *args5)
        fwd_cmp = bwd_compare(agg, fmg.generic_fwd_plain(cfg5, *args5), True, False)
        fwd36 = dict(
            ms=event_ms(lambda: fmg.generic_fwd(cfg5, *args5), iters=3, warmup=1),
            plain_ms=event_ms(lambda: fmg.generic_fwd_plain(cfg5, *args5), iters=1, warmup=1))
        hs5, h5, geo5, ws5, sels5 = args5
        b = bound(nbytes(hs5, h5, geo5, *ws5, *sels5, agg), kern5.flops_per_slot() * n_valid5)
        fwd36.update(bound_ms=b[0], bound_by=b[1], bytes_ms=b[2], ops_ms=b[3])
    d_agg5 = torch.randn((n, cfg5.out_dim), generator=gen, device=dev).to(bf)
    k36 = vjp_check("vjp_250k_attr36", kern5, cfg5, args5, n_valid5, d_agg5, VJP_TILES[0],
                    times=True)
    gc5 = vjp_grad_check(dev, SPARSE_LMAX_ATTR)
    emit("kernel_sparse", card=card, a=cfg5.a, valid_slots=n_valid5, fwd_compared=fwd_cmp,
         fwd_times=fwd36, vjp_times=k36["times"], step_ms_250k=step5_ms,
         tolerance=f"#11: {TOL_GENERIC_BWD_BF16_ULPS} bf16 ulps, as kernel_untabled")
    check(not fwd_cmp["over"] and fwd_cmp["finite"], f"#11 at A=36 vs plain: {fwd_cmp}")
    emit("grad_check_sparse", **gc5,
         tolerance=f"{TOL_GRAD_FP32} * max|ref| per parameter; fp32 sums in another order")
    emit("vjp_times", card=card, step_ms_250k=ab, step_ms_1m=step_ms_1m, kernel_250k=t14,
         sparse_step_ms_250k=step5_ms, sparse_forward_ms=fwd5_ms)
    del graph, g_bf, attrs_bf, attrs5, args5, d_agg5, agg
    piece = dict(piece_of=[fmg.GENERIC_BWD_VJP.name])
    return {
        fmg.GENERIC_BWD_VJP.name: dict(
            launches=launches_vjp[fmg.GENERIC_BWD_VJP.name],
            max_abs_err=kv[(bf, VJP_TILES[0])]["max_abs_err"], ms=t14["ms"],
            plain_ms=t14["plain_ms"], bound_ms=t14["bounds"]["whole"]["bound_ms"],
            bound_by=t14["bounds"]["whole"]["bound_by"], library_ms=None,
            chain_ms=t14["chain_ms"], bwd_tile=VJP_TILES[0]),
        fmg.GENERIC_BWD_VJP_WGRAD.name: dict(
            launches=launches_vjp[fmg.GENERIC_BWD_VJP_WGRAD.name],
            max_abs_err=kv[(bf, VJP_TILES[0])]["compared"]["dW1"]["max_abs_err"],
            ms=t14["wgrad_ms"], plain_ms=t14["wgrad_plain_ms"],
            bound_ms=t14["bounds"]["wgrad"]["bound_ms"],
            bound_by=t14["bounds"]["wgrad"]["bound_by"], library_ms=None,
            tiles_per_launch=kv[(bf, VJP_TILES[0])]["group"], **piece),
        "generic_fwd_attr36": dict(
            launches=launches5[fmg.GENERIC_FWD.name], max_abs_err=fwd_cmp["max_abs_err"],
            ms=fwd36["ms"], plain_ms=fwd36["plain_ms"], bound_ms=fwd36["bound_ms"],
            bound_by=fwd36["bound_by"], library_ms=None, instance="A=36 (lmax_attr=5)"),
    }


DIST_PARTS = 4  # the partitioned runs' P (and 1, the degenerate halo)
DIST_LMAX2_STEPS = 2
# (P, H, F): odd H and F, F=80 of config 3, and P=1
RING_SMALL = ((1, 37, 13), (2, 37, 13), (4, 129, 80), (8, 61, 7))
HALO_TPU_FILE = "scalable_e3_gnn_tpu/kernels/halo_rdma.py"
PARTITION_10M_PARTS = 16  # bench.py:128-140's partition_s_10m_p16
DIST_PROCS_WORLD = 2  # processes on the one card, each owning P / 2 partitions
DIST_PROCS_STEPS = 1 + TRAIN_STEPS  # a warm-up step, then the timed ones
DIST_PROCS_DIE_AT = 2  # rank 1 dies after the checkpoint of step 3, first incarnation only
DIST_PROCS_RTOL = 3e-4  # the partitioned runners' bf16 loss tolerance


def partition_arrays(graph):
    """(positions, features, senders, edge_mask) of a graph, host numpy."""
    return tuple(x.cpu().numpy() for x in (graph.positions, graph.nodes, graph.senders,
                                           graph.edge_mask))


def partition_edges(part, n: int) -> np.ndarray:
    """The sorted (receiver * n + sender) keys, in input node ids, of every
    valid slot of both blocks of every partition (halo senders through the
    pool to their owner's row)."""
    ni, npp, hcap = part.n_interior, part.n_per_part, part.halo_cap
    keys = []
    for p in range(part.num_parts):
        gid = part.global_ids[p].astype(np.int64)
        s_i = part.senders_int[p]
        keys.append((gid[:ni, None] * n + gid[np.minimum(s_i, npp - 1)])[part.mask_int[p]])
        s_b = part.senders_bnd[p]
        pool = part.halo_map[p][np.clip(s_b - npp, 0, hcap - 1)]
        q, j = pool // hcap, pool % hcap
        halo_gid = part.global_ids[q, part.boundary_idx[q, j]].astype(np.int64)
        sender = np.where(s_b < npp, gid[np.minimum(s_b, npp - 1)], halo_gid)
        keys.append((gid[ni:, None] * n + sender)[part.mask_bnd[p]])
    return np.sort(np.concatenate(keys))


def dist_inputs(model, part, dev, dtype):
    """The group, the shards and the precomputed attributes of a partition,
    the float arrays cast to ``dtype`` (bench_scaling.py's measure)."""
    group = dist.PartitionGroup(part.num_parts, dev)
    shards = dist.shard_partitioned_dense(part, group)
    attrs = dist.make_dist_geometry_dense(model, group)(shards)
    shards = [sh._replace(nodes=sh.nodes.to(dtype), positions_ext=sh.positions_ext.to(dtype))
              for sh in shards]
    return group, shards, [tuple(a.to(dtype) for a in at) for at in attrs]


def unpermute(out, part, n: int):
    """[P, Np, F] partition rows -> [n, F] input order."""
    gids = torch.as_tensor(part.global_ids.ravel(), device=out.device).long()
    flat = out.reshape(-1, out.shape[-1])
    res = flat.new_zeros((n, out.shape[-1]))
    res[gids[gids >= 0]] = flat[gids >= 0]
    return res


def dist_targets(target, part):
    """target[clip(global_ids, 0)]: [P, Np, F] (pad rows are masked)."""
    idx = torch.as_tensor(np.clip(part.global_ids, 0, None), device=target.device).long()
    return target[idx]


def dist_train_run(step, shards, targets, attrs, steps: int, want: dict) -> dict:
    """``steps`` counted steps, each timed by CUDA events: per-step launches
    against ``want``, finite losses; returns the losses, times and peak memory."""
    losses, per_step, step_ms = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        before = launch_counts()
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        m = step(shards, targets, attrs)
        ev[1].record()
        losses.append(m["loss"].item())
        torch.cuda.synchronize()
        step_ms.append(ev[0].elapsed_time(ev[1]))
        per_step.append({k: v - before[k] for k, v in launch_counts().items()})
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(all(s == want for s in per_step), f"launches per step {per_step}, expected {want}")
    return dict(losses=losses, step_ms=step_ms, launches_per_step=per_step[-1],
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def ring_phase(card: str, hcap: int) -> dict:
    """Phase 45, kernel_ring: #15 against its plain version at P = 1, 2, 4, 8
    on small shapes (odd H and F) and at config 3's P=4 [H, 80] (``hcap``
    rows) in bf16 and fp32, bitwise; device times of the kernel, its plain
    version and the library call at the P=4 bf16 shape; returns the numbers
    of #15's ``kernels`` row (but its launches)."""
    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    f3 = port.Irreps(HIDDEN).dim
    cases = [(p, h, f, dt) for p, h, f in RING_SMALL for dt in (torch.float32, bf)]
    cases += [(DIST_PARTS, hcap, f3, dt) for dt in (bf, torch.float32)]
    rows = []
    for p, h, f, dt in cases:
        x = torch.randn((p, h, f), generator=gen, device=dev).to(dt)
        got = hr.ring_all_gather_fwd(x)
        ref = hr.ring_all_gather_plain(x)
        plan = hr.ring_plan(p, nbytes(x[0]), (x.data_ptr(), got.data_ptr()))
        rows.append(dict(p=p, h=h, f=f, dtype=str(dt).replace("torch.", ""),
                         vec_bytes=plan["vec_bytes"], grid=plan["grid"],
                         bitwise_equal=bool(torch.equal(got, ref)),
                         max_abs_err=float((got.float() - ref.float()).abs().max())))
    ring_err = max(r["max_abs_err"] for r in rows)
    # device times per launch from a profiler trace (the per-call host time
    # of the wrapper is read apart, by CUDA events around the queue); the
    # plain version and the library call the same way
    x = torch.randn((DIST_PARTS, hcap, f3), generator=gen, device=dev).to(bf)
    ring_ms, ring_traced = kernel_device_ms(lambda: hr.ring_all_gather_fwd(x))
    x32 = x.float()
    ring32_ms, _ = kernel_device_ms(lambda: hr.ring_all_gather_fwd(x32))
    ring_event_ms = event_ms(lambda: hr.ring_all_gather_fwd(x), iters=50, warmup=5)
    plain_ms, plain_traced = kernel_device_ms(lambda: hr.ring_all_gather_plain(x))
    plain_event_ms = event_ms(lambda: hr.ring_all_gather_plain(x), iters=50, warmup=5)
    lib_out = torch.empty((DIST_PARTS,) + tuple(x.shape), dtype=x.dtype, device=dev)
    lib_call = lambda: lib_out.copy_(x.expand(DIST_PARTS, *x.shape))
    lib_ms, lib_traced = kernel_device_ms(lib_call)
    lib_event_ms = event_ms(lib_call, iters=50, warmup=5)
    check(torch.equal(lib_out, hr.ring_all_gather_plain(x)), "the library call's pools differ")
    del lib_out
    # bound: the function reads every export once and writes every pool
    # once, P + P^2 chunks; no arithmetic
    ring_bytes = (DIST_PARTS * DIST_PARTS + DIST_PARTS) * nbytes(x[0])
    ring_bound, ring_by, _, _ = bound(ring_bytes, 0)
    emit("kernel_ring", kernel=hr.RING.name, cases=rows, max_abs_err=ring_err,
         shape=[DIST_PARTS, hcap, f3], dtype="bfloat16", ms=ring_ms, ms_fp32=ring32_ms,
         traced_launches_of_50=dict(ring=ring_traced, plain=plain_traced, library=lib_traced),
         event_ms=dict(ring=ring_event_ms, plain=plain_event_ms, library=lib_event_ms),
         plain_ms=plain_ms, library_ms=lib_ms,
         library_call="pools.copy_(exports.expand(P, P, H, F))",
         bound_ms=ring_bound, bound_by=ring_by, bound_mbytes=ring_bytes / 1e6, card=card)
    check(all(r["bitwise_equal"] for r in rows), f"#15 vs plain: {rows}")
    return dict(max_abs_err=ring_err, ms=ring_ms, plain_ms=plain_ms, bound_ms=ring_bound,
                bound_by=ring_by, library_ms=lib_ms, shape=[DIST_PARTS, hcap, f3],
                dtype="bfloat16", times="device time from torch.profiler",
                event_ms=ring_event_ms)


def dist_phases(card: str, graph3) -> dict:
    """Phases 44-48: the dense partitioned path (``parallel.partition``,
    ``parallel.halo``: all P partitions on the card, stepped layer by layer)
    and kernel #15, the halo ring, on config 3's 100k graph (K=24,
    symmetrized; its tables unused) and the 250k lmax=2 graph.

    44. dist_partition -- partition_graph_dense at P = 1 and 4: host ms,
        NI, NB, H, the q of both transpose tables; every valid edge of the
        input found exactly once over the partitions' blocks.
    45. kernel_ring -- #15 against its plain version at P = 1, 2, 4, 8 on
        small shapes (odd H and F) and at config 3's P=4 [H, 80] in bf16 and
        fp32: bitwise equal (it only copies); device times (torch.profiler)
        of the kernel, its plain version and the one PyTorch call that
        builds the same pools, and its bound.
    46. dist_forward -- config 3's bf16 forward through make_dist_forward_dense
        at P=1 (all_gather) and P=4 (all_gather, ring), un-permuted by
        global_ids against the unpartitioned fp32 plain path on the same
        weights (TOL_FORWARD_BF16 * max|ref|) and bit for bit the
        unpartitioned bf16 kernel forward; ring and all_gather bitwise
        equal; per forward 2 blocks x P partitions x 4 layers of #3, and 4 of
        #15 under ring (one per layer).
    47. dist_train -- bench_scaling.py's measure at P=1 and at P=4 with each
        backend: a warm-up and 5 timed bf16 steps (fp32 masters, Adam 1e-3,
        precomputed geometry, the float shard arrays and attributes in
        bf16); per step 2 P 4 of #3, of #5 and of the reduction, and 4 of #15
        under ring; peak memory; the single-card untabled step timed beside;
        a torch.profiler trace of two steps at each P and backend.
    48. dist_grad_check -- fp32 at 20k points, P=4, both backends: the
        partitioned gradients and loss against autograd of the unpartitioned
        plain path.
    Then dist_lmax2 (``dist_lmax2_phase``).  Returns #15's row of the
    ``kernels`` line."""
    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    n = N_POINTS
    g100 = graph3._replace(**NO_TABLES)
    arrays = partition_arrays(g100)

    # ---- 44. the partitions
    parts = {}
    n_edges = int(arrays[3].sum())
    want_keys = np.sort((np.arange(n, dtype=np.int64)[:, None] * n
                         + arrays[2].astype(np.int64))[arrays[3]])
    for p in (1, DIST_PARTS):
        t0 = time.perf_counter()
        part = partition_graph_dense(*arrays, num_parts=p)
        host_ms = (time.perf_counter() - t0) * 1e3
        parts[p] = part
        found = partition_edges(part, n)
        emit("dist_partition", points=n, k=MAX_NEIGHBORS, num_parts=p, host_ms=host_ms,
             n_interior=part.n_interior, n_boundary=part.n_boundary, halo_cap=part.halo_cap,
             q_int=part.rev_int.shape[-1], q_ext=part.rev_ext.shape[-1],
             edges=n_edges, edges_found=int(found.size),
             interior_edges=int(part.mask_int.sum()), boundary_edges=int(part.mask_bnd.sum()))
        check(np.array_equal(found, want_keys),
              f"P={p}: the partitions' edges are not the input's, each once")
    del want_keys

    # ---- 45. kernel #15 against its plain version; times
    ring_row = ring_phase(card, parts[DIST_PARTS].halo_cap)

    # ---- 46. the partitioned config-3 forward (bf16), counted
    model = km_model(dev)
    model_bf = copy.deepcopy(model).to(bf)
    state32 = {k_: v.float() for k_, v in model_bf.state_dict().items()}
    plain32 = port.SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=NUM_LAYERS, layout="cm",
                         use_pallas=False, device=dev)
    plain32.load_state_dict(state32)
    runs = ((1, "all_gather"), (DIST_PARTS, "all_gather"), (DIST_PARTS, "ring"))
    outs, fwd_ms, fwd_launches = {}, {}, {}
    with torch.no_grad():
        attrs32 = plain32.compute_attributes_dense(g100)
        ref = plain32(g100, attrs=attrs32)
        uni = model_bf(g100._replace(nodes=g100.nodes.to(bf)),
                       attrs=tuple(a.to(bf) for a in attrs32)).float()
        del plain32, attrs32
        scale = float(ref.abs().max())
        for p, backend in runs:
            group, shards, attrs = dist_inputs(model_bf, parts[p], dev, bf)
            fwd = dist.make_dist_forward_dense(model_bf, group, backend)
            reset_launches()
            out = fwd(shards, attrs)
            torch.cuda.synchronize()
            launches = launch_counts()
            want = expected({fm.KM_FWD.name: 2 * p * NUM_LAYERS,
                             hr.RING.name: NUM_LAYERS if backend == "ring" else 0})
            full = unpermute(out, parts[p], n).float()
            err = float((full - ref).abs().max())
            err_uni = float((full - uni).abs().max())
            fwd_ms[f"P{p}_{backend}"] = event_ms(lambda: fwd(shards, attrs), iters=5, warmup=1)
            fwd_launches[f"P{p}_{backend}"] = launches
            outs[(p, backend)] = out
            emit("dist_forward", points=n, num_parts=p, backend=backend, dtype="bfloat16",
                 shape=list(out.shape), launches=launches, max_abs_ref=scale,
                 bf16_vs_fp32_plain_unpartitioned_max_abs_err=err,
                 vs_bf16_kernel_unpartitioned_max_abs_err=err_uni,
                 bf16_tolerance=f"{TOL_FORWARD_BF16} * max|ref|; bf16 storage through 4 layers",
                 forward_ms=fwd_ms[f"P{p}_{backend}"], card=card)
            check(launches == want, f"P={p} {backend}: {launches} launches, expected {want}")
            check(bool(torch.isfinite(out).all()), f"P={p} {backend}: non-finite output")
            check(err <= TOL_FORWARD_BF16 * scale,
                  f"P={p} {backend}: bf16 forward vs fp32 plain max abs err {err}")
            # a receiver's slot sum does not depend on the block it sits in
            check(err_uni == 0.0,
                  f"P={p} {backend}: not the unpartitioned bf16 forward bit for bit ({err_uni})")
            del shards, attrs, out, full
        same = torch.equal(outs[(DIST_PARTS, "ring")], outs[(DIST_PARTS, "all_gather")])
        emit("dist_forward_backends", num_parts=DIST_PARTS, ring_equals_all_gather=same)
        check(same, f"P={DIST_PARTS}: ring and all_gather forwards differ")
        del outs, ref, uni, model_bf

    # ---- 47. the partitioned train step (bench_scaling.py's measure)
    target = torch.from_numpy(np.random.default_rng(SEED + 2).standard_normal(
        (n, 3)).astype(np.float32)).to(dev)
    model_u = km_model(dev)
    opt = torch.optim.Adam(model_u.parameters(), lr=LEARNING_RATE, betas=(0.9, 0.999), eps=1e-8)
    step_u = make_train_step(model_u, bf16_loss, opt)
    with torch.no_grad():
        attrs_u = tuple(a.to(bf) for a in model_u.compute_attributes_dense(g100))
    g_bf = g100._replace(nodes=g100.nodes.to(bf))
    single_ms = event_ms(lambda: step_u(g_bf, attrs_u, target), iters=TRAIN_STEPS, warmup=1)
    del model_u, opt, step_u, attrs_u, g_bf
    train = {}
    for p, backend in runs:
        m = km_model(dev, remat=True)
        opt = torch.optim.Adam(m.parameters(), lr=LEARNING_RATE, betas=(0.9, 0.999), eps=1e-8)
        group, shards, attrs = dist_inputs(m, parts[p], dev, bf)
        targets = dist_targets(target, parts[p])
        step = dist.make_dist_train_step_dense(m, opt, group, backend, compute_dtype=bf)
        want = expected({fm.KM_FWD.name: 2 * p * NUM_LAYERS, fm.KM_BWD.name: 2 * p * NUM_LAYERS,
                         fm.TAB_BWD_REDUCE.name: 2 * p * NUM_LAYERS,
                         hr.RING.name: NUM_LAYERS if backend == "ring" else 0})
        warm = dist_train_run(step, shards, targets, attrs, 1, want)
        r = dist_train_run(step, shards, targets, attrs, TRAIN_STEPS, want)
        r["step_ms_mean"] = sum(r["step_ms"]) / len(r["step_ms"])
        train[f"P{p}_{backend}"] = r
        masters = all(q.dtype == torch.float32 for q in m.parameters())
        # where the device time of a step goes, at each P and backend
        emit("dist_profile", card=card, points=n, num_parts=p, backend=backend,
             **profile_steps(step, (shards, targets, attrs), host_top=12))
        emit("dist_train", points=n, num_parts=p, backend=backend, layers=NUM_LAYERS,
             compute_dtype="bfloat16", master_dtype="float32" if masters else "mixed",
             optimizer=f"Adam(lr={LEARNING_RATE}, betas=(0.9, 0.999), eps=1e-8)",
             warmup_ms=warm["step_ms"], **r, card=card)
        check(masters, "master weights are not all fp32")
        del m, opt, step, shards, attrs, targets
    p1 = train["P1_all_gather"]["step_ms_mean"]
    emit("dist_train_vs_single_card", single_card_untabled_step_ms=single_ms,
         dist_p1_step_ms=p1, ratio_p1_over_single=p1 / single_ms,
         dist_p4_step_ms={k: v["step_ms_mean"] for k, v in train.items()}, card=card)

    # ---- 48. fp32 gradients of the partitioned step against the plain path
    pts_gc = np.random.default_rng(SEED + 3).random((GC_POINTS, 3)).astype(np.float32)
    _, _, _, graph_gc, _ = build_graph(pts_gc, GC_RADIUS)
    graph_gc = graph_gc._replace(**NO_TABLES)
    m_p = port.SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=NUM_LAYERS, layout="cm",
                     use_pallas=False, device=dev)
    m_k = km_model(dev)
    m_p.load_state_dict(m_k.state_dict())
    with torch.no_grad():
        attrs_gc = m_p.compute_attributes_dense(graph_gc)
    t_gc = torch.from_numpy(np.random.default_rng(SEED + 4).standard_normal(
        (GC_POINTS, 3)).astype(np.float32)).to(dev)
    loss_p = mse_loss(m_p(graph_gc, attrs=attrs_gc), t_gc)
    loss_p.backward()
    part_gc = partition_graph_dense(*partition_arrays(graph_gc), num_parts=DIST_PARTS)
    group, shards, attrs = dist_inputs(m_k, part_gc, dev, torch.float32)
    targets = dist_targets(t_gc, part_gc)
    for backend in dist.BACKENDS:
        # lr 0: the step leaves the weights as they are and the gradients in .grad
        step = dist.make_dist_train_step_dense(m_k, torch.optim.SGD(m_k.parameters(), lr=0.0),
                                               group, backend)
        reset_launches()
        loss_k = step(shards, targets, attrs)["loss"].item()
        launches = launch_counts()
        worst, worst_name = 0.0, ""
        for (nm, a), b in zip(m_k.named_parameters(), m_p.parameters(), strict=True):
            rel = float((a.grad - b.grad).abs().max()) / max(float(b.grad.abs().max()), 1e-30)
            if rel > worst:
                worst, worst_name = rel, nm
        want = expected({fm.KM_FWD.name: 2 * DIST_PARTS * NUM_LAYERS,
                         fm.KM_BWD.name: 2 * DIST_PARTS * NUM_LAYERS,
                         fm.TAB_BWD_REDUCE.name: 2 * DIST_PARTS * NUM_LAYERS,
                         hr.RING.name: NUM_LAYERS if backend == "ring" else 0})
        emit("dist_grad_check", points=GC_POINTS, radius=GC_RADIUS, num_parts=DIST_PARTS,
             backend=backend, dtype="float32", n_interior=part_gc.n_interior,
             n_boundary=part_gc.n_boundary, halo_cap=part_gc.halo_cap, loss_dist=loss_k,
             loss_plain=loss_p.item(), worst_param=worst_name, worst_rel_err=worst,
             launches=launches,
             tolerance=f"{TOL_GRAD_FP32} * max|ref| per parameter; fp32 sums in another order")
        check(worst <= TOL_GRAD_FP32, f"{backend}: fp32 gradients {worst_name} off by {worst}")
        check(abs(loss_k - loss_p.item()) <= 1e-5 * loss_p.item(), f"{backend}: losses differ")
        check(launches == want, f"{backend}: {launches} launches, expected {want}")
    del m_p, m_k, graph_gc, shards, attrs

    return {hr.RING.name: dict(launches=fwd_launches[f"P{DIST_PARTS}_ring"][hr.RING.name],
                               **ring_row)}


def dist_procs_phase(card: str, graph3) -> dict:
    """Phase 49b, dist_procs: the dense partitioned train step over
    ``torch.distributed``, two processes on the one card (gloo; both ranks on
    ``cuda:0``), each owning two of config 3's four partitions.

    This process writes the graph arrays, the seeded weights and the target
    once (``parallel.dense_worker.write_inputs``), runs the one-process P=4
    reference (the bf16 forward, a warm-up and 5 timed bf16 steps, fp32
    masters, Adam 1e-3), and launches the workers through
    ``dense_worker.run_world`` (the ``Supervisor``) twice: fault-free, and
    with rank 1 killed (``inject_failure``) after the checkpoint of step
    3.  The kernel libraries are already built (phase 2).  Each rank
    partitions the whole graph, keeps its two partitions, runs their bf16
    forward, then the steps with a heartbeat and its own checkpoint each.
    Checked: the ranks' partition equals this process's (digest); each rank's
    forward equals the one-process forward of its partitions bit for bit;
    both ranks report the same losses, within ``DIST_PROCS_RTOL`` of the
    one-process curve; their parameters and optimizer states are equal bit
    for bit; per rank and step 2 blocks x 2 partitions x 4 layers of #3, of
    #5 and of the reduction, nothing else; the killed run restarts once and
    ends on the fault-free run's parameters bit for bit.  Read: step ms per
    rank (CUDA events) beside the one-process step, the host ms in
    collectives per step, the supervisor's detection-to-resumed seconds.
    Returns the launches per kernel that rank 0 measured in its last step
    (equal on both ranks), and what ``ring_procs_phase`` reuses: the inputs,
    the one-process forward and the fault-free world's results."""
    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    n = N_POINTS
    g100 = graph3._replace(**NO_TABLES)
    arrays = partition_arrays(g100)
    target = torch.from_numpy(np.random.default_rng(SEED + 2).standard_normal(
        (n, 3)).astype(np.float32)).to(dev)
    model_kw = dict(input_irreps="2x0e+1x1o", hidden_irreps=HIDDEN, output_irreps="1x1o",
                    num_layers=NUM_LAYERS, layout="cm", use_pallas=True, remat=True)
    model = port.SEGNN(**model_kw, device=dev, generator=torch.Generator().manual_seed(SEED))
    weights = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}

    # ---- the one-process P=4 reference, in this process
    part = partition_graph_dense(*arrays, num_parts=DIST_PARTS)
    group, shards, attrs = dist_inputs(model, part, dev, bf)
    targets = dist_targets(target, part)
    with torch.no_grad():
        ref_fwd = dist.make_dist_forward_dense(copy.deepcopy(model).to(bf), group)(
            shards, attrs).float().cpu().numpy()
    opt = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE, betas=(0.9, 0.999), eps=1e-8)
    step = dist.make_dist_train_step_dense(model, opt, group, compute_dtype=bf)
    per_rank = {fm.KM_FWD.name: 2 * (DIST_PARTS // DIST_PROCS_WORLD) * NUM_LAYERS,
                fm.KM_BWD.name: 2 * (DIST_PARTS // DIST_PROCS_WORLD) * NUM_LAYERS,
                fm.TAB_BWD_REDUCE.name: 2 * (DIST_PARTS // DIST_PROCS_WORLD) * NUM_LAYERS}
    ref = dist_train_run(step, shards, targets, attrs, DIST_PROCS_STEPS,
                         expected({k: DIST_PROCS_WORLD * v for k, v in per_rank.items()}))
    ref_ms = ref["step_ms"][1:]
    del model, opt, step, shards, attrs, targets, group
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the workers' memory comes from the same card

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        dense_worker.write_inputs(
            tmp / "in", *arrays, target, model_kw, weights, num_parts=DIST_PARTS,
            steps=DIST_PROCS_STEPS, lr=LEARNING_RATE, compute_dtype="bfloat16")
        clean = world_run(card, tmp / "in", tmp / "fault_free", DIST_PROCS_WORLD)
        killed = world_run(card, tmp / "in", tmp / "rank1_killed", DIST_PROCS_WORLD, 1,
                           env={"E3GNN_DIE_AT_STEP": str(DIST_PROCS_DIE_AT),
                                "E3GNN_DIE_PROCESS": "1"})
    res = clean["res"]
    sha = dense_worker.partition_digest(part)
    fwd_equal = {}
    for r in range(DIST_PROCS_WORLD):
        lo, hi = res[r]["partitions"]
        got, want = clean["files"][r]["forward"], ref_fwd[lo:hi]
        fwd_equal[r] = got.shape == want.shape and got.tobytes() == want.tobytes()
    losses = res[0]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    params = sorted(k for k in clean["files"][0] if k.startswith("param/"))
    same_params = all(clean["files"][0][k].tobytes() == clean["files"][1][k].tobytes()
                      for k in params)
    restart_equal = all(killed["files"][r][k].tobytes() == clean["files"][0][k].tobytes()
                        for r in range(DIST_PROCS_WORLD) for k in params)
    launches_ok = all(ls == per_rank for r in range(DIST_PROCS_WORLD)
                      for ls in res[r]["launches_per_step"])
    kres = killed["res"]
    detect_s = max(kres[r]["resumed_at"] for r in kres) - killed["report"].failed_at[0]
    rank_ms = {r: res[r]["step_ms"][1:] for r in range(DIST_PROCS_WORLD)}
    mean = lambda xs: sum(xs) / len(xs)
    emit("dist_procs", card=card, points=n, k=MAX_NEIGHBORS, layers=NUM_LAYERS,
         num_parts=DIST_PARTS, world=DIST_PROCS_WORLD, backend="gloo (all_gather of CUDA tensors)",
         devices=[res[r]["device"] for r in range(DIST_PROCS_WORLD)],
         partitions={r: res[r]["partitions"] for r in range(DIST_PROCS_WORLD)},
         compute_dtype="bfloat16", master_dtype="float32",
         optimizer=f"Adam(lr={LEARNING_RATE}, betas=(0.9, 0.999), eps=1e-8)",
         steps=DIST_PROCS_STEPS, timed_steps="all but the first",
         partition_same_as_parent=all(res[r]["partition_sha"] == sha for r in res),
         forward_bitwise_one_process=fwd_equal,
         losses={r: res[r]["losses"] for r in res}, one_process_losses=ref["losses"],
         max_rel_loss_vs_one_process=max(rel), first_loss_equal=losses[0] == ref["losses"][0],
         rtol=f"{DIST_PROCS_RTOL}: the partitioned runners' bf16 loss tolerance",
         params_bitwise_across_ranks=same_params,
         state_sha={r: res[r]["state_sha"] for r in res},
         launches_per_rank_step={r: res[r]["launches_per_step"][-1] for r in res},
         step_ms_per_rank=rank_ms, step_ms_mean_per_rank={r: mean(v) for r, v in rank_ms.items()},
         one_process_p4_step_ms=ref_ms, one_process_p4_step_ms_mean=mean(ref_ms),
         collective_host_ms_per_step={r: res[r]["comm_ms"] for r in res},
         collective_host_ms_mean={r: mean(res[r]["comm_ms"][1:]) for r in res},
         world_wall_s=clean["wall"],
         killed=dict(events=killed["report"].events, restarts=killed["report"].restarts,
                     resumed_from_step={r: kres[r]["start_step"] for r in kres},
                     detect_to_resumed_s=detect_s, world_wall_s=killed["wall"],
                     final_params_bitwise_fault_free=restart_equal),
         scaling="none computed: the two processes time-slice one card")
    check(all(res[r]["partition_sha"] == sha for r in res), "the ranks' partitions differ")
    check(all(fwd_equal.values()), f"forward not the one-process P=4 forward: {fwd_equal}")
    check(res[0]["losses"] == res[1]["losses"], "the ranks report different losses")
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    check(max(rel) <= DIST_PROCS_RTOL, f"loss curve {max(rel)} relative off one process")
    check(same_params and res[0]["state_sha"] == res[1]["state_sha"],
          "the ranks' parameters or optimizer states differ")
    check(launches_ok, f"launches per rank and step "
                       f"{ {r: res[r]['launches_per_step'] for r in res} }, expected {per_rank}")
    check(restart_equal and all(kres[r]["state_sha"] == res[0]["state_sha"] for r in kres),
          "the restarted run did not end on the fault-free parameters")
    measured = res[0]["launches_per_step"][-1]
    check(all(res[r]["launches_per_step"][-1] == measured for r in res),
          "the ranks launched different kernels in the last step")
    ctx = dict(arrays=arrays, target=target.cpu().numpy(), model_kw=model_kw, weights=weights,
               ref_fwd=ref_fwd, halo_cap=part.halo_cap, per_rank=per_rank, res=res,
               files=clean["files"], wall=clean["wall"])
    return measured, ctx


def dist_lmax2_phase(card: str) -> None:
    """Phase 49, dist_lmax2: the 250k lmax=2 graph and model of bench.py:225-240
    (remat, bf16, the residual backward) partitioned at P=4 with the ring
    exchange: a counted forward (2 blocks x 4 partitions x 4 layers of #11,
    4 of #15) against the unpartitioned fp32 plain path on the same weights
    (TOL_FORWARD_BF16 * max|ref|) and bit for bit against the unpartitioned
    bf16 kernel forward, then 2 counted train steps (per step 32
    each of #11 in save mode, #12, its weight-gradient kernel and the
    reduction; 4 of #15)."""
    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    n = L2_POINTS
    pts = np.random.default_rng(SEED + 5).random((n, 3)).astype(np.float32)
    tile = SEGNNLayer._pick_generic_tile(n)
    _, _, _, graph, _ = build_graph(pts, radius=L2_RADIUS, levels=L2_OCTREE_LEVELS,
                                    k=L2_NEIGHBORS, cap=L2_CELL_CAPACITY, tile=tile)
    graph = graph._replace(**NO_TABLES)
    t0 = time.perf_counter()
    part = partition_graph_dense(*partition_arrays(graph), num_parts=DIST_PARTS)
    host_ms = (time.perf_counter() - t0) * 1e3
    model = lmax2_model(dev, remat=True)
    model_bf = copy.deepcopy(model).to(bf)
    plain32 = lmax2_model(dev, use_pallas=False)
    plain32.load_state_dict({k: v.float() for k, v in model_bf.state_dict().items()})
    blocks = 2 * DIST_PARTS * NUM_LAYERS
    with torch.no_grad():
        attrs32 = plain32.compute_attributes_dense(graph)
        ref = plain32(graph, attrs=attrs32)
        uni = model_bf(graph._replace(nodes=graph.nodes.to(bf)),
                       attrs=tuple(a.to(bf) for a in attrs32)).float()
        del plain32, attrs32
        group, shards, attrs = dist_inputs(model_bf, part, dev, bf)
        fwd = dist.make_dist_forward_dense(model_bf, group, "ring")
        reset_launches()
        out = fwd(shards, attrs)
        torch.cuda.synchronize()
        launches = launch_counts()
        full = unpermute(out, part, n).float()
        scale = float(ref.abs().max())
        err = float((full - ref).abs().max())
        err_uni = float((full - uni).abs().max())
        fwd_ms = event_ms(lambda: fwd(shards, attrs), iters=2, warmup=1)
    want = expected({fmg.GENERIC_FWD.name: blocks, hr.RING.name: NUM_LAYERS})
    emit("dist_lmax2_forward", points=n, num_parts=DIST_PARTS, backend="ring",
         launches=launches, max_abs_ref=scale, bf16_vs_fp32_plain_unpartitioned_max_abs_err=err,
         vs_bf16_kernel_unpartitioned_max_abs_err=err_uni, forward_ms=fwd_ms, card=card)
    check(launches == want, f"lmax=2 P={DIST_PARTS}: {launches} launches, expected {want}")
    check(bool(torch.isfinite(out).all()), "lmax=2 partitioned forward: non-finite output")
    check(err <= TOL_FORWARD_BF16 * scale, f"lmax=2 partitioned bf16 forward: {err}")
    check(err_uni == 0.0, f"lmax=2 P={DIST_PARTS}: not the unpartitioned bf16 forward bit for "
          f"bit ({err_uni})")
    del ref, uni, out, full, model_bf, shards, attrs
    target = torch.from_numpy(np.random.default_rng(SEED + 15).standard_normal(
        (n, 3)).astype(np.float32)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE, betas=(0.9, 0.999), eps=1e-8)
    group, shards, attrs = dist_inputs(model, part, dev, bf)
    step = dist.make_dist_train_step_dense(model, opt, group, "ring", compute_dtype=bf)
    want_step = expected({fmg.GENERIC_FWD.name: blocks, fmg.GENERIC_BWD_RES.name: blocks,
                          fmg.GENERIC_TAB_BWD_WGRAD.name: blocks,
                          fm.TAB_BWD_REDUCE.name: blocks, hr.RING.name: NUM_LAYERS})
    r = dist_train_run(step, shards, dist_targets(target, part), attrs, DIST_LMAX2_STEPS,
                       want_step)
    emit("dist_lmax2", points=n, hidden=L2_HIDDEN, num_parts=DIST_PARTS, backend="ring",
         partition_host_ms=host_ms, n_interior=part.n_interior, n_boundary=part.n_boundary,
         halo_cap=part.halo_cap, forward_launches=launches, max_abs_ref=scale,
         bf16_vs_fp32_plain_unpartitioned_max_abs_err=err,
         bf16_tolerance=f"{TOL_FORWARD_BF16} * max|ref|; bf16 storage through 4 layers",
         forward_ms=fwd_ms, train=r, card=card)
    del model, opt, step, shards, attrs, graph


# the COO partitioned path, dp over clouds, the overlapped exchange
COO_DIST_STEPS = 3  # the first checked against autograd, the other two timed
COO_DIST_MIN_POINTS = 12_500  # the smallest halving the step may fall to
DP_CLOUDS = 2  # clouds of points seeds 0 and 1
DP_WORLD = 4  # processes on the one card: 2 dp rows x 2 graph ranks
DP_STEPS = 1 + TRAIN_STEPS  # a warm-up step, then the timed ones
TOL_COO_DIST_FWD = 2e-5  # x max(1, max|ref|): JAX's test_partition_invariance_forward
TOL_COO_DIST_GRAD = 5e-5  # x max|ref| per parameter: its test_gradient_parity_through_halo
TOL_COO_DIST_LOSS = 1e-6  # relative: the same fp32 sums in another order
TOL_COO_DP_LOSS = 1e-5  # relative: __graft_entry__.py dryrun_multichip's check


def coo_cloud(n: int, seed: int):
    """Config 3's cloud at ``n`` points (config 3's density: r scaled by
    (100000 / n)^(1/3); octree 6 levels, K=24) as the receiver-sorted COO
    graph of ``radius_graph_cell`` (not symmetrized), with its plans, and
    its host arrays for ``partition_graph``."""
    dev = torch.device(DEVICE)
    radius = RADIUS * (N_POINTS / n) ** (1 / 3)
    pts = np.random.default_rng(seed).random((n, 3)).astype(np.float32)
    tree = port.build_octree(pts, LO, HI, num_levels=OCTREE_LEVELS, device=dev)
    cap = port.suggest_cell_capacity(tree, radius, LO, HI)
    e = port.radius_graph_cell(tree, radius, LO, HI, max_neighbors=MAX_NEIGHBORS,
                               cell_capacity=cap)
    feats = torch.from_numpy(np.random.default_rng(SEED + 1).standard_normal(
        (n, 5)).astype(np.float32)).to(dev)
    g = port.SteerableGraph(nodes=feats, positions=tree.points, senders=e.senders,
                            receivers=e.receivers,
                            node_graph=torch.zeros(n, dtype=torch.int32, device=dev),
                            node_mask=torch.ones(n, dtype=torch.bool, device=dev),
                            edge_mask=e.mask).with_plans()
    arrays = tuple(x.cpu().numpy() for x in (tree.points, feats, e.senders, e.receivers, e.mask))
    return g, arrays, radius


def coo_model(dev):
    """Config 3's SEGNN (lmax_attr=1, fp32, weights from the seed) for the
    COO graph: plain PyTorch, no hand kernel."""
    return port.SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=NUM_LAYERS, lmax_attr=1,
                      device=dev, generator=torch.Generator().manual_seed(SEED))


def coo_partition_edges(part, n: int) -> np.ndarray:
    """The sorted (receiver * n + sender) keys, in input node ids, of every
    valid edge of every COO partition (halo senders through the pool to
    their owner's row)."""
    npp, hcap = part.n_per_part, part.halo_cap
    keys = []
    for p in range(part.num_parts):
        s, r, m = part.senders[p], part.receivers[p], part.edge_mask[p]
        pool = part.halo_map[p][np.clip(s - npp, 0, hcap - 1)]
        q, j = pool // hcap, pool % hcap
        halo_gid = q.astype(np.int64) * npp + part.boundary_idx[q, j]
        sender = np.where(s < npp, p * npp + np.minimum(s, npp - 1), halo_gid)
        keys.append(((p * npp + r.astype(np.int64)) * n + sender)[m])
    return np.sort(np.concatenate(keys))


def coo_dist_targets(target, part):
    """target[clip(global_ids, 0)]: [P, Np, F] (pad rows are masked)."""
    return target[torch.as_tensor(np.clip(part.global_ids, 0, None), device=target.device).long()]


def coo_step_run(card: str, n: int) -> dict:
    """The COO P=4 train step (ring, fp32, Adam 1e-3) on the cloud of ``n``
    points: autograd of the unpartitioned COO model first (its gradients and
    loss, and 3 timed steps of it after one), then 3 counted steps of the
    partitioned one on the same weights, the first held against those
    gradients and that loss, the other two timed; peak memory."""
    dev = torch.device(DEVICE)
    g, arrays, radius = coo_cloud(n, SEED)
    target = torch.from_numpy(np.random.default_rng(SEED + 2).standard_normal(
        (n, 3)).astype(np.float32)).to(dev)
    ref = coo_model(dev)
    opt_u = torch.optim.Adam(ref.parameters(), lr=LEARNING_RATE, betas=(0.9, 0.999), eps=1e-8)
    step_u = make_train_step(ref, lambda m, g_, t: mse_loss(m(g_), t), opt_u)
    torch.cuda.reset_peak_memory_stats()
    loss_ref = mse_loss(ref(g), target)
    loss_ref.backward()
    ref_grads = [p.grad.detach().clone() for p in ref.parameters()]
    loss_ref = loss_ref.item()
    single_ms = event_ms(lambda: step_u(g, target), iters=2, warmup=1)
    single_peak = torch.cuda.max_memory_allocated() / 1e9
    del ref, opt_u, step_u
    part = partition_graph(*arrays, num_parts=DIST_PARTS)
    group = dist.PartitionGroup(DIST_PARTS, dev)
    shards = dist.shard_partitioned(part, group)
    targets = coo_dist_targets(target, part)
    del g
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    model = coo_model(dev)
    opt = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE, betas=(0.9, 0.999), eps=1e-8)
    step = dist.make_dist_train_step(model, opt, group, "ring")
    want = expected({hr.RING.name: NUM_LAYERS})
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step, worst, worst_name = [], [], [], 0.0, ""
    for i in range(COO_DIST_STEPS):
        before = launch_counts()
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        m = step(shards, targets)
        ev[1].record()
        losses.append(m["loss"].item())
        torch.cuda.synchronize()
        step_ms.append(ev[0].elapsed_time(ev[1]))
        per_step.append({k: v - before[k] for k, v in launch_counts().items()})
        if i == 0:  # the gradients of the first step are the unpartitioned ones
            for (nm, a), b in zip(model.named_parameters(), ref_grads, strict=True):
                rel = float((a.grad - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                if rel > worst:
                    worst, worst_name = rel, nm
    peak = torch.cuda.max_memory_allocated() / 1e9
    rel_loss = abs(losses[0] - loss_ref) / abs(loss_ref)
    out = dict(points=n, radius=radius, edges=int(arrays[4].sum()), backend="ring",
               losses=losses, loss_unpartitioned=loss_ref, loss_rel_err=rel_loss,
               worst_param=worst_name, worst_grad_rel_err=worst,
               step_ms=step_ms, step_ms_timed_mean=sum(step_ms[1:]) / len(step_ms[1:]),
               unpartitioned_step_ms=single_ms, peak_mem_gb=peak,
               unpartitioned_peak_mem_gb=single_peak, launches_per_step=nonzero(per_step[-1]),
               halo_cap=part.halo_cap, n_per_part=part.n_per_part)
    emit("coo_dist_train", card=card, **out,
         tolerance=f"gradients {TOL_COO_DIST_GRAD} * max|ref| per parameter, loss "
                   f"{TOL_COO_DIST_LOSS} relative")
    check(all(math.isfinite(x) for x in losses), f"COO step: non-finite loss {losses}")
    check(all(s == want for s in per_step), f"COO step launches {per_step}, expected {want}")
    check(worst <= TOL_COO_DIST_GRAD, f"COO step: gradients {worst_name} off by {worst}")
    check(rel_loss <= TOL_COO_DIST_LOSS, f"COO step: loss {losses[0]} vs {loss_ref}")
    return out


def coo_dp_run(card: str, n: int) -> dict:
    """The COO dp x graph step: clouds of points seeds 0 and 1 at ``n``
    points each, P=4, the caps ``shared_caps`` unifies (tight, as
    ``dryrun_multichip``); one step (ring, Adam 1e-3) whose loss must be the
    mean of the two unpartitioned single-cloud MSEs."""
    dev = torch.device(DEVICE)
    model = coo_model(dev)
    clouds = [coo_cloud(n, SEED + d) for d in range(DP_CLOUDS)]
    gen = np.random.default_rng(SEED + 32)
    targets = [torch.from_numpy(gen.standard_normal((n, 3)).astype(np.float32)).to(dev)
               for _ in clouds]
    with torch.no_grad():
        singles = [mse_loss(model(g), t).item() for (g, _, _), t in zip(clouds, targets)]
    parts = [partition_graph(*a, num_parts=DIST_PARTS) for _, a, _ in clouds]
    caps = shared_caps(parts)
    parts = [partition_graph(*a, num_parts=DIST_PARTS, **caps) for _, a, _ in clouds]
    del clouds
    group = dist.PartitionGroup(DIST_PARTS, dev)
    cloud_group = dist.CloudGroup(DP_CLOUDS, group)
    shards = [dist.shard_partitioned(p, group) for p in parts]
    stacked = torch.stack([coo_dist_targets(t, p) for t, p in zip(targets, parts)])
    opt = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE, betas=(0.9, 0.999), eps=1e-8)
    step = dist.make_dist_train_step(model, opt, group, "ring", dp=cloud_group)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    loss, ms = sync_time(lambda: step(shards, stacked)["loss"].item())
    launches = launch_counts()
    want_loss = sum(singles) / len(singles)
    rel = abs(loss - want_loss) / abs(want_loss)
    out = dict(points_per_cloud=n, clouds=DP_CLOUDS, num_parts=DIST_PARTS, caps=caps,
               loss=loss, single_cloud_mse=singles, mean_single=want_loss, loss_rel_err=rel,
               step_ms_host=ms, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=nonzero(launches))
    emit("coo_dist_dp", card=card, **out, tolerance=f"{TOL_COO_DP_LOSS} relative")
    check(launches == expected({hr.RING.name: DP_CLOUDS * NUM_LAYERS}),
          f"COO dp step launches {launches}")
    check(rel <= TOL_COO_DP_LOSS, f"COO dp loss {loss} vs the clouds' mean MSE {want_loss}")
    return out


def largest_fitting(card: str, label: str, run, n: int) -> dict:
    """``run(card, n)`` at ``n`` points, halved at config 3's density while
    the card runs out of memory (not below ``COO_DIST_MIN_POINTS``); the
    cut, if any, is printed."""
    tried = []
    while True:
        try:
            out = run(card, n)
            break
        except torch.cuda.OutOfMemoryError as e:
            tried.append(dict(points=n, error=str(e).splitlines()[0][:200]))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        n //= 2
        check(n >= COO_DIST_MIN_POINTS, f"{label}: out of memory down to {n * 2} points")
    emit("coo_dist_cut", card=card, step=label, points=n, full_points=N_POINTS,
         out_of_memory_at=tried, cut=n != N_POINTS)
    return out


def coo_dist_phase(card: str) -> dict:
    """Phase 49c, coo_dist: config 3 as a COO graph (100k points, octree 6
    levels, radius_graph_cell r=0.04, K=24, not symmetrized; SEGNN 2x0e+1x1o
    -> 32x0e+16x1o x4 -> 1x1o, lmax_attr=1, fp32, weights from the seed)
    partitioned by ``partition_graph`` at P=4.

    Checked: every valid edge in exactly one partition; the partitioned
    forward with each backend within TOL_COO_DIST_FWD * max(1, max|ref|) of
    the unpartitioned COO forward, ring = all_gather bit for bit, 4 of #15
    per forward under ring and nothing else; 3 steps (ring, Adam 1e-3), the
    first's gradients and loss against autograd of the unpartitioned model
    (``coo_step_run``), 4 of #15 per step and nothing else; then the dp x
    graph step of two clouds (``coo_dp_run``).  The steps run at the largest
    halving of the points that fits the card (``largest_fitting``).  Read:
    forward ms, step ms, peak memory, #15's device ms per launch at this
    path's export shape.  Returns #15's launches per step."""
    dev = torch.device(DEVICE)
    n = N_POINTS
    g, arrays, _ = coo_cloud(n, SEED)
    n_edges = int(arrays[4].sum())
    t0 = time.perf_counter()
    part = partition_graph(*arrays, num_parts=DIST_PARTS)
    host_ms = (time.perf_counter() - t0) * 1e3
    found = coo_partition_edges(part, n)
    want_keys = np.sort((arrays[3].astype(np.int64) * n + arrays[2])[arrays[4]])
    emit("coo_dist_partition", points=n, num_parts=DIST_PARTS, host_ms=host_ms,
         n_per_part=part.n_per_part, halo_cap=part.halo_cap, edges=n_edges,
         edges_found=int(found.size), edges_per_part=part.senders.shape[1],
         local_edges=int(part.mask_loc.sum()), remote_edges=int(part.mask_rem.sum()))
    check(np.array_equal(found, want_keys), "COO P=4: the partitions' edges are not the "
                                            "input's, each once")
    del found, want_keys
    model = coo_model(dev)
    group = dist.PartitionGroup(DIST_PARTS, dev)
    shards = dist.shard_partitioned(part, group)
    outs, fwd = {}, {}
    with torch.no_grad():
        ref = model(g)
        scale = max(1.0, float(ref.abs().max()))
        single_ms = event_ms(lambda: model(g), iters=3, warmup=1)
        for backend in dist.BACKENDS:
            run = dist.make_dist_forward(model, group, backend)
            reset_launches()
            out = run(shards)
            torch.cuda.synchronize()
            launches = launch_counts()
            err = float((out.reshape(-1, 3)[:n] - ref).abs().max())
            ms = event_ms(lambda: run(shards), iters=3, warmup=1)
            fwd[backend] = dict(launches=nonzero(launches), max_abs_err=err, forward_ms=ms)
            outs[backend] = out
            check(launches == expected({hr.RING.name: NUM_LAYERS if backend == "ring" else 0}),
                  f"COO P={DIST_PARTS} {backend}: {launches} launches")
            check(bool(torch.isfinite(out).all()), f"COO {backend}: non-finite output")
            check(err <= TOL_COO_DIST_FWD * scale, f"COO {backend}: forward off by {err}")
        same = torch.equal(outs["ring"], outs["all_gather"])
    coo_fwd = outs["all_gather"].cpu().numpy()
    coo_weights = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del outs, ref, g
    # #15 at this path's shape: the fp32 exports [P, H, 80]
    x = torch.randn((DIST_PARTS, part.halo_cap, port.Irreps(HIDDEN).dim),
                    generator=torch.Generator(device=dev).manual_seed(SEED + 41), device=dev)
    ring_ms, _ = kernel_device_ms(lambda: hr.ring_all_gather_fwd(x))
    ring_bound, ring_by, _, _ = bound((DIST_PARTS * DIST_PARTS + DIST_PARTS) * nbytes(x[0]), 0)
    emit("coo_dist_forward", card=card, points=n, edges=n_edges, num_parts=DIST_PARTS,
         dtype="float32", max_abs_ref=scale, tolerance=f"{TOL_COO_DIST_FWD} * max(1, max|ref|)",
         ring_equals_all_gather=same, unpartitioned_forward_ms=single_ms, **fwd,
         ring_fp32_shape=list(x.shape), ring_ms_per_launch=ring_ms, ring_bound_ms=ring_bound,
         ring_bound_by=ring_by)
    check(same, "COO: ring and all_gather forwards differ")
    del shards, x
    torch.cuda.empty_cache()
    st = largest_fitting(card, "coo_dist_train", coo_step_run, n)
    dp = largest_fitting(card, "coo_dist_dp", coo_dp_run, st["points"])
    emit("coo_dist", card=card, points=n, forward_ms={k: v["forward_ms"] for k, v in fwd.items()},
         unpartitioned_forward_ms=single_ms, step_points=st["points"],
         step_ms_timed_mean=st["step_ms_timed_mean"],
         unpartitioned_step_ms=st["unpartitioned_step_ms"], peak_mem_gb=st["peak_mem_gb"],
         dp_points_per_cloud=dp["points_per_cloud"], dp_step_ms_host=dp["step_ms_host"],
         dp_peak_mem_gb=dp["peak_mem_gb"], ring_ms_per_launch=ring_ms)
    return {"launches_per_step": st["launches_per_step"].get(hr.RING.name, 0),
            "ring_ms_fp32": ring_ms, "arrays": arrays, "forward": coo_fwd,
            "weights": coo_weights, "halo_cap": part.halo_cap}


def dense_cloud(seed: int):
    """Config 3's dense graph of the points of ``seed`` (symmetrized, no
    gather tables), as the partitioned path reads it."""
    pts = np.random.default_rng(seed).random((N_POINTS, 3)).astype(np.float32)
    return build_graph(pts, tables=False)[3]


def world_run(card: str, in_dir: Path, out_dir: Path, world: int = DP_WORLD,
              restarts: int = 0, env=None) -> dict:
    """``dense_worker.run_world`` with ``world`` ranks on the card (``env``
    added to theirs): the report and results, every rank's file, the wall
    time; fails unless it ran with exactly ``restarts`` restarts."""
    t0 = time.perf_counter()
    report, res = dense_worker.run_world(in_dir, out_dir, world, env=env,
                                         heartbeat_timeout_s=120.0, startup_timeout_s=240.0,
                                         wall_timeout_s=420.0, max_restarts=restarts)
    wall = time.perf_counter() - t0
    logs = "\n".join(f"{p.name}: {p.read_text()[-1500:]}"
                     for p in sorted(out_dir.glob("log_*.txt")))
    check(report.ok and report.restarts == restarts and sorted(res) == list(range(world)),
          f"{out_dir.name}: {report}\n{logs}")
    files = {r: dict(np.load(out_dir / f"rank{r}.npz")) for r in res}
    return dict(report=report, res=res, files=files, wall=wall)


def dp_phases(card: str) -> dict:
    """Phases 49d-49e: the dense path with data parallelism over clouds, bf16
    on fp32 masters, Adam 1e-3, the kernels on (remat), on two config-3
    clouds (points seeds 0 and 1) x P=4 under the caps ``shared_caps``
    unifies.

    49d. dp_dense -- in one process (``CloudGroup(2)``): each cloud's bf16
        forward, a warm-up and 5 timed steps, per step 2 clouds x 4
        partitions x 2 blocks x 4 layers = 64 each of #3, #5 and the
        reduction; then ``dense_worker.run_world`` as 4 processes on the
        card, 2 dp rows x 2 graph ranks (each rank one cloud and two
        partitions; gloo): each rank's partition digest this process's, its
        forward bit for bit the one-process forward of its partitions; all
        ranks report the same losses, within DIST_PROCS_RTOL of the
        one-process curve; parameters and Adam states equal across ranks bit
        for bit; 16 each of #3, #5 and the reduction per rank and step.
    49e. overlap -- the same world again with ``serialize_exchange``: its
        forward, losses and final parameters equal the overlapped run's bit
        for bit.  Read: step ms per rank and host ms in collectives per step,
        both ways.
    Returns the launches per step of #3, #5 and the reduction, one process
    and per rank, and what ``ring_procs_phase`` reuses (``ctx``)."""
    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    clouds = [dense_cloud(SEED + d) for d in range(DP_CLOUDS)]
    arrays = [partition_arrays(g) for g in clouds]
    del clouds
    caps = shared_caps([partition_graph_dense(*a, num_parts=DIST_PARTS) for a in arrays])
    parts = [partition_graph_dense(*a, num_parts=DIST_PARTS, **caps) for a in arrays]
    gen = np.random.default_rng(SEED + 2)
    targets = [torch.from_numpy(gen.standard_normal((N_POINTS, 3)).astype(np.float32)).to(dev)
               for _ in range(DP_CLOUDS)]
    model_kw = dict(input_irreps="2x0e+1x1o", hidden_irreps=HIDDEN, output_irreps="1x1o",
                    num_layers=NUM_LAYERS, layout="cm", use_pallas=True, remat=True)
    model = port.SEGNN(**model_kw, device=dev, generator=torch.Generator().manual_seed(SEED))
    weights = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}

    # ---- 49d, one process
    inputs = [dist_inputs(model, p, dev, bf) for p in parts]
    group = inputs[0][0]
    shards, attrs = [i[1] for i in inputs], [i[2] for i in inputs]
    stacked = torch.stack([dist_targets(t, p) for t, p in zip(targets, parts)])
    blocks = 2 * DIST_PARTS * NUM_LAYERS
    with torch.no_grad():
        fwd = dist.make_dist_forward_dense(copy.deepcopy(model).to(bf), group)
        reset_launches()
        ref_fwd = [fwd(s, a).float().cpu().numpy() for s, a in zip(shards, attrs)]
        fwd_launches = launch_counts()
        fwd_ms = event_ms(lambda: [fwd(s, a) for s, a in zip(shards, attrs)], iters=3, warmup=1)
        del fwd
    check(fwd_launches == expected({fm.KM_FWD.name: DP_CLOUDS * blocks}),
          f"dp forward launches {fwd_launches}")
    opt = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE, betas=(0.9, 0.999), eps=1e-8)
    step = dist.make_dist_train_step_dense(model, opt, group, compute_dtype=bf,
                                           dp=dist.CloudGroup(DP_CLOUDS, group))
    per_step = {fm.KM_FWD.name: DP_CLOUDS * blocks, fm.KM_BWD.name: DP_CLOUDS * blocks,
                fm.TAB_BWD_REDUCE.name: DP_CLOUDS * blocks}
    ref = dist_train_run(step, shards, stacked, attrs, DP_STEPS, expected(per_step))
    ref_ms = ref["step_ms"][1:]
    del model, opt, step, shards, attrs, stacked, inputs, group
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the workers' memory comes from the same card

    per_rank = {k: v // (DP_WORLD // DP_CLOUDS) // DP_CLOUDS for k, v in per_step.items()}
    mean = lambda xs: sum(xs) / len(xs)
    sha = dense_worker.partition_digest(*parts)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        stack = lambda i: np.stack([a[i] for a in arrays])
        common = dict(num_parts=DIST_PARTS, steps=DP_STEPS, lr=LEARNING_RATE,
                      compute_dtype="bfloat16", num_clouds=DP_CLOUDS)
        runs = {}
        for label, serialize in (("overlap", False), ("serialized", True)):
            dense_worker.write_inputs(
                tmp / f"in_{label}", stack(0), stack(1), stack(2), stack(3),
                np.stack([t.cpu().numpy() for t in targets]), model_kw, weights, **common,
                serialize_exchange=serialize)
            runs[label] = world_run(card, tmp / f"in_{label}", tmp / label)

    clean = runs["overlap"]
    res, files = clean["res"], clean["files"]
    fwd_equal, layout_ok = {}, True
    for r in range(DP_WORLD):
        d, g = divmod(r, DP_WORLD // DP_CLOUDS)
        (c_lo, _), (lo, hi) = res[r]["clouds"], res[r]["partitions"]
        layout_ok &= res[r]["clouds"] == [d, d + 1] and [lo, hi] == [2 * g, 2 * g + 2]
        got, want = files[r]["forward"], ref_fwd[c_lo][lo:hi][None]
        fwd_equal[r] = got.shape == want.shape and got.tobytes() == want.tobytes()
    losses = res[0]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    params = sorted(k for k in files[0] if k.startswith("param/"))
    same_params = all(files[r][k].tobytes() == files[0][k].tobytes()
                      for r in range(DP_WORLD) for k in params)
    launches_ok = all(ls == per_rank for r in range(DP_WORLD) for ls in res[r]["launches_per_step"])
    rank_ms = {r: res[r]["step_ms"][1:] for r in range(DP_WORLD)}
    emit("dp_dense", card=card, points_per_cloud=N_POINTS, clouds=DP_CLOUDS, num_parts=DIST_PARTS,
         caps=caps, layers=NUM_LAYERS, compute_dtype="bfloat16", master_dtype="float32",
         optimizer=f"Adam(lr={LEARNING_RATE}, betas=(0.9, 0.999), eps=1e-8)",
         one_process=dict(forward_ms_both_clouds=fwd_ms, forward_launches=nonzero(fwd_launches),
                          step_ms=ref_ms, step_ms_mean=mean(ref_ms), losses=ref["losses"],
                          launches_per_step=nonzero(ref["launches_per_step"]),
                          peak_mem_gb=ref["peak_mem_gb"]),
         world=DP_WORLD, layout="2 dp rows x 2 graph ranks, rank = d * 2 + g",
         devices=[res[r]["device"] for r in range(DP_WORLD)],
         clouds_per_rank={r: res[r]["clouds"] for r in res},
         partitions_per_rank={r: res[r]["partitions"] for r in res},
         partition_same_as_parent=all(res[r]["partition_sha"] == sha for r in res),
         forward_bitwise_one_process=fwd_equal, losses={r: res[r]["losses"] for r in res},
         max_rel_loss_vs_one_process=max(rel), first_loss_equal=losses[0] == ref["losses"][0],
         rtol=f"{DIST_PROCS_RTOL}: the partitioned runners' bf16 loss tolerance",
         params_bitwise_across_ranks=same_params,
         launches_per_rank_step={r: res[r]["launches_per_step"][-1] for r in res},
         step_ms_per_rank=rank_ms, step_ms_mean_per_rank={r: mean(v) for r, v in rank_ms.items()},
         collective_host_ms_per_step={r: res[r]["comm_ms"] for r in res},
         collective_host_ms_mean={r: mean(res[r]["comm_ms"][1:]) for r in res},
         world_wall_s=clean["wall"],
         scaling="none computed: the four processes time-slice one card")
    check(layout_ok, f"ranks not laid out dp-major: {[(res[r]['clouds'], res[r]['partitions']) for r in res]}")
    check(all(res[r]["partition_sha"] == sha for r in res), "the ranks' partitions differ")
    check(all(fwd_equal.values()), f"forward not the one-process forward: {fwd_equal}")
    check(all(res[r]["losses"] == losses for r in res), "the ranks report different losses")
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    check(max(rel) <= DIST_PROCS_RTOL, f"dp loss curve {max(rel)} relative off one process")
    check(same_params and all(res[r]["state_sha"] == res[0]["state_sha"] for r in res),
          "the ranks' parameters or optimizer states differ")
    check(launches_ok, f"launches per rank and step "
                       f"{ {r: res[r]['launches_per_step'] for r in res} }, expected {per_rank}")

    # ---- 49e, overlapped against serialized
    ser = runs["serialized"]
    same_fwd = all(ser["files"][r]["forward"].tobytes() == files[r]["forward"].tobytes()
                   for r in range(DP_WORLD))
    same_losses = all(ser["res"][r]["losses"] == res[r]["losses"] for r in range(DP_WORLD))
    same_final = all(ser["files"][r][k].tobytes() == files[r][k].tobytes()
                     for r in range(DP_WORLD) for k in params)
    both = {label: dict(
        step_ms_per_rank={r: run["res"][r]["step_ms"][1:] for r in range(DP_WORLD)},
        step_ms_mean_per_rank={r: mean(run["res"][r]["step_ms"][1:]) for r in range(DP_WORLD)},
        collective_host_ms_per_step={r: run["res"][r]["comm_ms"] for r in range(DP_WORLD)},
        collective_host_ms_mean={r: mean(run["res"][r]["comm_ms"][1:]) for r in range(DP_WORLD)},
        world_wall_s=run["wall"]) for label, run in runs.items()}
    emit("overlap", card=card, world=DP_WORLD, forward_bitwise=same_fwd, losses_equal=same_losses,
         final_params_bitwise=same_final, serialize_flags=[
             runs[k]["res"][0]["serialize_exchange"] for k in ("overlap", "serialized")],
         **both)
    check([runs[k]["res"][0]["serialize_exchange"] for k in ("overlap", "serialized")]
          == [False, True], "the runs did not take the serialize switch")
    check(same_fwd and same_losses and same_final,
          f"overlapped and serialized differ: forward {same_fwd}, losses {same_losses}, "
          f"parameters {same_final}")
    ctx = dict(arrays=arrays, targets=np.stack([t.cpu().numpy() for t in targets]),
               model_kw=model_kw, weights=weights, common=common, per_rank=per_rank,
               res=res, files=files, wall=clean["wall"])
    return dict(one_process=ref["launches_per_step"], per_rank=res[0]["launches_per_step"][-1],
                ctx=ctx)


# kernel #15 between processes on the one card (kernels/halo_ring.py::IpcRing)
RING_STRESS_EXCHANGES = 200
RING_SKIP_AT = 5  # the stress world's last rank skips the publish of its 5th fault exchange
RING_FAULT_TIMEOUT_S = 2.0  # the wait bound of that check (the runners' is RING_WAIT_S)
RING_COO_STEPS = 1


def same_files(a: dict, b: dict, prefix: str) -> bool:
    """Every array of ``a``'s and ``b``'s files whose key starts with
    ``prefix`` equal bit for bit, rank by rank."""
    return all(k in b[r] and a[r][k].tobytes() == b[r][k].tobytes()
               for r in a for k in a[r] if k.startswith(prefix))


def ring_procs_phase(card: str, procs: dict, dpc: dict, cooc: dict) -> dict:
    """Phase 49f, ring_procs: kernel #15 between processes that share the
    card (``IpcRing``: a publish kernel into the rank's IPC-mapped staging
    buffer, a gather kernel from every rank's), on both partitioned paths.

    (a) stress: ``parallel.ring_stress`` with 2 processes, 200 exchanges
        each of config 3's [2, H, 80] exports in bf16 and fp32 and of [2,
        37, 13] bf16, back to back with random device delays; every pool bit
        for bit gloo's all-gather of the same exports; then the last rank
        skips a publish and every rank raises within the bound, naming it.
    (b) dist_procs's config-3 P=4 world (``procs``) with ``"backend":
        "ring"``: each rank's forward bit for bit the one-process forward,
        the losses and final parameters bit for bit the all_gather world's
        of this call; per rank and step 16 of #3, #5 and the reduction and 4
        each of the publish and the gather; then rank 1 killed after step
        3's checkpoint: one restart, the final parameters bit for bit.
    (c) dp_dense's 4-process world (``dpc``: 2 dp rows x 2 graph ranks, each
        row a ring of its own) under ring: forward, losses and final
        parameters bit for bit the all_gather world's.
    (d) coo_dist's P=4 graph (``cooc``) as 2 processes under ring, one fp32
        step: each rank's forward bit for bit the one-process all_gather
        forward (which the all_gather worlds equal bit for bit), 4 publishes
        and 4 gathers a step.
    Read: per-rank step ms and gloo host ms beside the all_gather worlds',
    the gather's and the publish's device ms per step (CUDA events, the
    wait included), the kernels' device ms alone and their bounds, gloo's
    host ms for the same exports.  Returns the two kernels' rows of the
    ``kernels`` line and #15's readings."""
    mean = lambda xs: sum(xs) / len(xs)
    pub, gat = hr.IPC_PUBLISH.name, hr.IPC_GATHER.name
    ring_per_step = {pub: NUM_LAYERS, gat: NUM_LAYERS}
    hcap = procs["halo_cap"]

    # ---- (a) the stress world and the skipped publish
    shapes = f"2x{hcap}x80:bfloat16,2x{hcap}x80:float32,2x37x13:bfloat16"
    stress = ring_stress.run_world(world=DIST_PROCS_WORLD, exchanges=RING_STRESS_EXCHANGES,
                                   shapes=shapes, skip_at=RING_SKIP_AT,
                                   timeout_s=RING_FAULT_TIMEOUT_S, wall_timeout_s=300.0)
    ranks = stress["ranks"]
    emit("ring_stress", card=card, world=DIST_PROCS_WORLD, exchanges=RING_STRESS_EXCHANGES,
         shapes=shapes, wall_s=stress["wall_s"], fails=stress["fails"],
         per_rank={r: dict(shapes=o["shapes"], fault=o.get("fault"), launches=o["launches"])
                   for r, o in ranks.items()})
    check(not stress["fails"], f"ring stress: {stress['fails']}")
    main_shape = [o["shapes"][0] for o in ranks.values()]  # config 3's bf16 [2, H, 80]
    stage = main_shape[0]["bytes_per_rank"]
    # bounds: publish reads P_local chunks and writes them; gather reads P
    # chunks (every rank's buffer) and writes P
    pub_bound, pub_by, _, _ = bound(2 * stage, 0)
    gat_bound, gat_by, _, _ = bound(2 * DIST_PROCS_WORLD * stage, 0)
    stress_row = dict(
        publish_ms=max(o["publish_ms_median"] for o in main_shape),
        gather_copy_ms=max(o["gather_copy_ms_median"] for o in main_shape),
        gather_in_situ_ms_median=max(o["gather_ms_median"] for o in main_shape),
        gather_in_situ_ms_max=max(o["gather_ms_max"] for o in main_shape),
        gloo_ms=max(o["gloo_all_gather_host_ms_median"] for o in main_shape),
        torch_copy_ms=max(o["torch_copy_ms"] for o in main_shape),
        max_abs_err=max(s_["max_abs_err"] for o in ranks.values() for s_ in o["shapes"]))

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # ---- (b) dist_procs's world under ring, fault-free and rank 1 killed
        dense_worker.write_inputs(
            tmp / "in_dist", *procs["arrays"], procs["target"], procs["model_kw"],
            procs["weights"], num_parts=DIST_PARTS, steps=DIST_PROCS_STEPS, lr=LEARNING_RATE,
            compute_dtype="bfloat16", backend="ring")
        clean = world_run(card, tmp / "in_dist", tmp / "dist", DIST_PROCS_WORLD)
        killed = world_run(card, tmp / "in_dist", tmp / "dist_killed", DIST_PROCS_WORLD, 1,
                           env={"E3GNN_DIE_AT_STEP": str(DIST_PROCS_DIE_AT),
                                "E3GNN_DIE_PROCESS": "1"})
        # ---- (c) dp_dense's world under ring
        stack = lambda i: np.stack([a[i] for a in dpc["arrays"]])
        dense_worker.write_inputs(
            tmp / "in_dp", stack(0), stack(1), stack(2), stack(3), dpc["targets"],
            dpc["model_kw"], dpc["weights"], **dpc["common"], backend="ring")
        dpr = world_run(card, tmp / "in_dp", tmp / "dp")
        # ---- (d) the COO graph as 2 processes under ring
        coo_arrays = cooc["arrays"]
        coo_kw = dict(input_irreps="2x0e+1x1o", hidden_irreps=HIDDEN, output_irreps="1x1o",
                      num_layers=NUM_LAYERS, lmax_attr=1)
        coo_target = np.random.default_rng(SEED + 2).standard_normal(
            (coo_arrays[0].shape[0], 3)).astype(np.float32)
        dense_worker.write_inputs(
            tmp / "in_coo", coo_arrays[0], coo_arrays[1], coo_arrays[2], coo_arrays[4],
            coo_target, coo_kw, cooc["weights"], receivers=coo_arrays[3], num_parts=DIST_PARTS,
            steps=RING_COO_STEPS, lr=LEARNING_RATE, compute_dtype="float32", layout="coo",
            backend="ring")
        coo = world_run(card, tmp / "in_coo", tmp / "coo", DIST_PROCS_WORLD)

    # ---- (b) checks and readings
    res, ares = clean["res"], procs["res"]
    fwd_equal = {}
    for r in range(DIST_PROCS_WORLD):
        lo, hi = res[r]["partitions"]
        got, want = clean["files"][r]["forward"], procs["ref_fwd"][lo:hi]
        fwd_equal[r] = got.shape == want.shape and got.tobytes() == want.tobytes()
    want_rank = {**procs["per_rank"], **ring_per_step}
    launches_ok = all(ls == want_rank for r in res for ls in res[r]["launches_per_step"])
    losses_equal = all(res[r]["losses"] == ares[r]["losses"] for r in res)
    params_equal = same_files(procs["files"], clean["files"], "param/")
    restart_equal = same_files(clean["files"], killed["files"], "param/")
    rank_ms = {r: res[r]["step_ms"][1:] for r in res}
    gather_ms = {r: [m["gather"] for m in res[r]["ring_ms_per_step"][1:]] for r in res}
    publish_ms = {r: [m["publish"] for m in res[r]["ring_ms_per_step"][1:]] for r in res}
    kres = killed["res"]
    detect_s = max(kres[r]["resumed_at"] for r in kres) - killed["report"].failed_at[0]
    emit("ring_procs_dist", card=card, points=N_POINTS, num_parts=DIST_PARTS,
         world=DIST_PROCS_WORLD, backend="ring (IpcRing: #15 between processes)",
         devices=[res[r]["device"] for r in res], forward_bitwise_one_process=fwd_equal,
         losses={r: res[r]["losses"] for r in res}, losses_equal_all_gather_world=losses_equal,
         final_params_bitwise_all_gather_world=params_equal,
         launches_per_rank_step={r: res[r]["launches_per_step"][-1] for r in res},
         step_ms_per_rank=rank_ms, step_ms_mean_per_rank={r: mean(v) for r, v in rank_ms.items()},
         all_gather_step_ms_mean_per_rank={r: mean(ares[r]["step_ms"][1:]) for r in ares},
         collective_host_ms_mean={r: mean(res[r]["comm_ms"][1:]) for r in res},
         all_gather_collective_host_ms_mean={r: mean(ares[r]["comm_ms"][1:]) for r in ares},
         gather_device_ms_per_step=gather_ms, publish_device_ms_per_step=publish_ms,
         gather_device_ms_per_launch_mean={r: mean(v) / NUM_LAYERS for r, v in gather_ms.items()},
         gather_bound_ms=gat_bound, world_wall_s=clean["wall"],
         all_gather_world_wall_s=procs["wall"],
         killed=dict(restarts=killed["report"].restarts, events=killed["report"].events,
                     resumed_from_step={r: kres[r]["start_step"] for r in kres},
                     final_params_bitwise_fault_free=restart_equal,
                     detect_to_resumed_s=detect_s, world_wall_s=killed["wall"]))
    check(all(fwd_equal.values()), f"ring world: forward not the one-process one: {fwd_equal}")
    check(losses_equal and params_equal,
          "ring world: losses or parameters differ from the all_gather world's")
    check(launches_ok, f"ring world launches {[res[r]['launches_per_step'] for r in res]}, "
                       f"expected {want_rank} per rank and step")
    check(restart_equal and all(kres[r]["state_sha"] == res[0]["state_sha"] for r in kres),
          "ring world: the restart did not end on the fault-free parameters")

    # ---- (c) checks
    dres, dares = dpr["res"], dpc["res"]
    dp_want = {**dpc["per_rank"], **ring_per_step}
    dp_fwd = same_files(dpc["files"], dpr["files"], "forward")
    dp_params = same_files(dpc["files"], dpr["files"], "param/")
    dp_losses = all(dres[r]["losses"] == dares[r]["losses"] for r in dres)
    dp_launch = all(ls == dp_want for r in dres for ls in dres[r]["launches_per_step"])
    dp_ms = {r: mean(dres[r]["step_ms"][1:]) for r in dres}
    emit("ring_procs_dp", card=card, world=DP_WORLD, layout="2 dp rows x 2 graph ranks, a ring "
         "per row", forward_bitwise=dp_fwd, losses_equal=dp_losses, final_params_bitwise=dp_params,
         launches_per_rank_step={r: dres[r]["launches_per_step"][-1] for r in dres},
         step_ms_mean_per_rank=dp_ms,
         all_gather_step_ms_mean_per_rank={r: mean(dares[r]["step_ms"][1:]) for r in dares},
         collective_host_ms_mean={r: mean(dres[r]["comm_ms"][1:]) for r in dres},
         all_gather_collective_host_ms_mean={r: mean(dares[r]["comm_ms"][1:]) for r in dares},
         gather_device_ms_per_step={r: [m["gather"] for m in dres[r]["ring_ms_per_step"][1:]]
                                    for r in dres},
         world_wall_s=dpr["wall"], all_gather_world_wall_s=dpc["wall"])
    check(dp_fwd and dp_losses and dp_params,
          f"dp ring world: forward {dp_fwd}, losses {dp_losses}, parameters {dp_params}")
    check(dp_launch, f"dp ring world launches {[dres[r]['launches_per_step'] for r in dres]}")

    # ---- (d) checks
    cres = coo["res"]
    coo_fwd = {}
    for r in range(DIST_PROCS_WORLD):
        lo, hi = cres[r]["partitions"]
        got, want = coo["files"][r]["forward"], cooc["forward"][lo:hi]
        coo_fwd[r] = got.shape == want.shape and got.tobytes() == want.tobytes()
    coo_launch = all(ls == ring_per_step for r in cres for ls in cres[r]["launches_per_step"])
    emit("ring_procs_coo", card=card, points=coo_arrays[0].shape[0], cut=False,
         num_parts=DIST_PARTS, world=DIST_PROCS_WORLD, halo_cap=cooc["halo_cap"],
         forward_bitwise_one_process_all_gather=coo_fwd,
         losses={r: cres[r]["losses"] for r in cres},
         launches_per_rank_step={r: cres[r]["launches_per_step"][-1] for r in cres},
         step_ms={r: cres[r]["step_ms"] for r in cres},
         gather_device_ms_per_step={r: [m["gather"] for m in cres[r]["ring_ms_per_step"]]
                                    for r in cres},
         world_wall_s=coo["wall"])
    check(all(coo_fwd.values()), f"COO ring world: forward not the all_gather one: {coo_fwd}")
    check(coo_launch and all(math.isfinite(x) for r in cres for x in cres[r]["losses"]),
          f"COO ring world: launches {[cres[r]['launches_per_step'] for r in cres]}")

    launches = res[0]["launches_per_step"][-1]
    gat_step = mean([x for v in gather_ms.values() for x in v])
    pub_step = mean([x for v in publish_ms.values() for x in v])
    rows = {
        pub: dict(launches=launches.get(pub, 0), max_abs_err=stress_row["max_abs_err"],
                  ms=stress_row["publish_ms"], plain_ms=stress_row["torch_copy_ms"],
                  bound_ms=pub_bound, bound_by=pub_by, library_ms=stress_row["torch_copy_ms"],
                  shape=[2, hcap, 80], dtype="bfloat16",
                  times="device time by CUDA events around the launch (ring_stress)",
                  ms_per_launch_in_dist_procs=pub_step / NUM_LAYERS,
                  library_call="exports copied by Tensor.copy_"),
        gat: dict(launches=launches.get(gat, 0), max_abs_err=stress_row["max_abs_err"],
                  ms=stress_row["gather_copy_ms"], plain_ms=stress_row["gloo_ms"],
                  bound_ms=gat_bound, bound_by=gat_by, library_ms=stress_row["gloo_ms"],
                  shape=[DIST_PARTS, hcap, 80], dtype="bfloat16",
                  times="device time by CUDA events, every flag up (the copy alone); "
                        "plain and library: gloo all_gather of the same exports, host ms",
                  ms_in_situ_stress_median=stress_row["gather_in_situ_ms_median"],
                  ms_per_launch_in_dist_procs=gat_step / NUM_LAYERS,
                  launches_per_rank_step_dp=dres[0]["launches_per_step"][-1].get(gat, 0),
                  launches_per_rank_step_coo=cres[0]["launches_per_step"][-1].get(gat, 0)),
    }
    return dict(rows=rows, launches_per_rank_step=launches.get(gat, 0),
                ms_between_processes=stress_row["gather_copy_ms"])


# configs 1 and 2 on the COO path (train/runners.py)
COO_STEPS = 25  # runner steps on the card (the configs train 2,000 and 5,000)
COO_TIMED = 20  # CUDA-event steps after a warm-up
COO_CPU_STEPS = 5  # steps run on the card and on the CPU from the same weights
COO_RESUME = 4  # N of the resume check: 2N steps = N, save, restore, N
COO_RESUME_SIZE = dict(nbody=dict(graphs=64), qm9=dict(molecules=128))  # full widths
TOL_COO_CPU = 1e-5  # relative per loss: the same fp32 math, summed in another order
GATE_INIT = Path(__file__).resolve().parent / "tests" / "fixtures" / "gate_init.npz"
# tests/test_accuracy_gate.py: (input, hidden, output irreps, model keywords, init
# seed, learning rate, steps)
COO_GATES = {
    "nbody": ("2x0e+1x1o", "16x0e+8x1o", "1x1o", dict(num_layers=3, vel_attr=True), 0,
              5e-3, 400),
    "qm9": ("5x0e", "16x0e+8x1o", "1x0e", dict(num_layers=2, task="graph"), 1, 3e-3, 250),
}


def read_log(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def untimed(records) -> list:
    """Metrics records without their host-clock fields."""
    return [{k: v for k, v in r.items() if k not in ("time_s", "edges_per_s")} for r in records]


def digest(module) -> str:
    """SHA-256 of every parameter's bytes, in order."""
    h = hashlib.sha256()
    for p in module.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def coo_phase(card: str, which: str) -> dict:
    """Config 1 ('nbody') or 2 ('qm9') through its runner: the runs, checks
    and times of phase 50; returns the phase's readings."""
    from scalable_e3_gnn_torch.train import runners
    from scalable_e3_gnn_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from scalable_e3_gnn_torch.train.metrics import MetricsLogger
    from scalable_e3_gnn_torch.train.pipeline import make_train_state
    from scalable_e3_gnn_torch.utils import config

    dev = torch.device(DEVICE)
    cfg = getattr(config, f"{which}_config")()
    run = getattr(runners, f"run_{which}")
    setup_of = getattr(runners, f"{which}_setup")
    kw = dict(graphs=256) if which == "nbody" else dict(molecules=512)
    out = dict(card=card, tf32=torch.backends.cuda.matmul.allow_tf32,
               fp32_matmul_precision=torch.get_float32_matmul_precision())
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    with tempfile.TemporaryDirectory() as tmp:
        # the main path: the runner on the card, every launch count zeroed
        # before and read after (the COO path has no hand kernel)
        reset_launches()
        res, run_ms = sync_time(lambda: run(cfg, steps=COO_STEPS, log=f"{tmp}/card.jsonl",
                                            device=dev, **kw))
        launches = launch_counts()
        check(launches == expected({}), f"{which}: hand kernels launched: {launches}")
        log = read_log(f"{tmp}/card.jsonl")
        losses = [r["loss"] for r in log[:COO_STEPS]]
        finite = all(math.isfinite(v) for v in losses) and all(
            math.isfinite(v) for v in res.values() if isinstance(v, float))
        check(finite and len(losses) == COO_STEPS, f"{which}: non-finite result {res}")
        check(losses[-1] < losses[0], f"{which}: the loss did not move: {losses}")
        # the same run again on the card: the same bits
        res2 = run(cfg, steps=COO_STEPS, log=f"{tmp}/card2.jsonl", device=dev, **kw)
        rerun = res2 == res and untimed(read_log(f"{tmp}/card2.jsonl")) == untimed(log)
        check(rerun, f"{which}: two card runs differ")
        # the same seed on the CPU: the same weights, the same first losses
        w_card = digest(setup_of(cfg, device=dev, **kw).model)
        w_cpu = digest(setup_of(cfg, device="cpu", **kw).model)
        check(w_card == w_cpu, f"{which}: the initial weights differ between card and CPU")
        run(cfg, steps=COO_CPU_STEPS, log=f"{tmp}/cpu.jsonl", device="cpu", **kw)
        cpu_losses = [r["loss"] for r in read_log(f"{tmp}/cpu.jsonl")[:COO_CPU_STEPS]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
        check(rel <= TOL_COO_CPU, f"{which}: card vs CPU losses off by {rel} relative")
        # resume on the card: 2N steps = N, save, restore, N, bit for bit
        rkw = COO_RESUME_SIZE[which]
        a, b = setup_of(cfg, device=dev, **rkw), setup_of(cfg, device=dev, **rkw)
        cfg_other = copy.deepcopy(cfg)
        cfg_other.train.seed += 1  # other weights: all of them must come from the file
        c = setup_of(cfg_other, device=dev, **rkw)
        nb = len(a.batches)
        for i in range(2 * COO_RESUME):
            a.step(*a.batches[i % nb])
        state_b = make_train_state(b.model, b.optimizer)
        for i in range(COO_RESUME):
            b.step(*a.batches[i % nb])
            state_b.step += 1
        save_checkpoint(f"{tmp}/ckpt", COO_RESUME, state_b)
        state_c, at = restore_checkpoint(f"{tmp}/ckpt", make_train_state(c.model, c.optimizer))
        for i in range(at, 2 * COO_RESUME):
            c.step(*a.batches[i % nb])
        resume = (digest(a.model) == digest(c.model) and all(
            torch.equal(x, y) for sa, sc in zip(a.optimizer.state.values(),
                                                c.optimizer.state.values())
            for x, y in zip(sa.values(), sc.values())))
        check(resume, f"{which}: the resumed run differs from the straight one")
        if which == "nbody":  # and through the runner's own resume
            rcfg = copy.deepcopy(cfg)
            rcfg.train.checkpoint_every = COO_RESUME
            straight = run(rcfg, steps=2 * COO_RESUME, device=dev, **rkw)
            run(rcfg, steps=COO_RESUME, ckpt_dir=f"{tmp}/r", device=dev, **rkw)
            resumed = run(rcfg, steps=2 * COO_RESUME, ckpt_dir=f"{tmp}/r", resume=True,
                          device=dev, **rkw)
            check(resumed == straight, f"run_nbody resume: {resumed} != {straight}")

    # times: CUDA events over the steps after a warm-up, the batches in turn
    s = setup_of(cfg, device=dev, **kw)
    turn = itertools.cycle(s.batches)
    stepper = lambda: s.step(*next(turn))
    for _ in range(3):
        stepper()
    step_ms = event_ms(stepper, iters=COO_TIMED, warmup=0)
    logger = MetricsLogger(None, stdout_every=0)  # the runner's per-step float() reads

    def host_ms(log_each: bool) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(COO_TIMED):
            m = stepper()
            if log_each:
                logger.log(i, m)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / COO_TIMED

    no_log_ms, log_ms = host_ms(False), host_ms(True)
    eval_res, eval_ms = sync_time(s.evaluate)
    with torch.no_grad():
        fwd_ms = event_ms(lambda: s.model(*s.batches[0][:-1]), iters=COO_TIMED)
    prof = profile_steps(s.step, s.batches[0], steps=1)
    g0 = s.batches[0][0]
    out.update(
        config=dict(model=dataclasses.asdict(cfg.model), learning_rate=cfg.train.learning_rate,
                    **kw),
        nodes_per_batch=g0.num_nodes, edges_per_batch=g0.num_edges,
        valid_edges_per_batch=int(g0.edge_mask.sum()), batches=len(s.batches),
        result=res, run_ms_incl_data=run_ms, losses=losses, launches=launches,
        rerun_bit_identical=rerun, cpu_losses=cpu_losses, cpu_max_rel_err=rel,
        cpu_tolerance=f"{TOL_COO_CPU} relative per loss; fp32 sums in another order",
        initial_weights_equal=w_card == w_cpu, resume_bitwise=resume,
        resume_steps=f"{2 * COO_RESUME} = {COO_RESUME} + save/restore + {COO_RESUME}",
        step_ms=step_ms, step_host_ms_no_logging=no_log_ms, step_host_ms_logging=log_ms,
        eval_ms_incl_data=eval_ms, eval_result=eval_res, forward_ms=fwd_ms,
        launches_per_step=prof["launches_per_step"],
        device_busy_share=prof["device_busy_share"], profile=prof)
    emit(f"coo_{which}", **out)
    return out


def coo_gates(card: str) -> dict:
    """Phase 51: the accuracy gates of tests/test_accuracy_gate.py on the card,
    from JAX's initial weights (checked) and from the port's own (read)."""
    from scalable_e3_gnn_torch.data.nbody import generate_dataset, make_fully_connected_edges
    from scalable_e3_gnn_torch.data.qm9 import batch_molecules, generate_molecules
    from scalable_e3_gnn_torch.graph.batching import batch_same_size
    from scalable_e3_gnn_torch.utils.params import params_from_jax

    dev = torch.device(DEVICE)
    with np.load(GATE_INIT) as f:
        flat = {k: f[k] for k in f.files}
    s, r = make_fully_connected_edges(5)

    def nbody_batch(graphs, seed):
        ds = generate_dataset(graphs, num_steps=500, seed=seed)
        feats = np.concatenate([(ds["vel0"] ** 2).sum(-1, keepdims=True),
                                ds["charges"][..., None], ds["vel0"]], -1)
        g = batch_same_size(feats, ds["pos0"], s, r, device=dev).with_plans()
        t = lambda a: torch.from_numpy(a.reshape(-1, 3)).to(dev)
        return g, t(ds["vel0"]), t(ds["disp"])

    def jax_tree(which):
        tree = {}
        for key in flat:
            if key.startswith(which + "/"):
                node = tree
                *path, leaf = key.split("/")[1:]
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = flat[key]
        return tree

    out = {}
    for which, (ins, hid, outs, mkw, seed, lr, steps) in COO_GATES.items():
        if which == "nbody":
            batch = nbody_batch(64, 0)
            loss_fn = lambda m, g, v, t: mse_loss(m(g, v), t)
        else:
            g, t = batch_molecules(generate_molecules(48, seed=2), device=dev)
            batch = (g.with_plans(), t)
            loss_fn = lambda m, g_, t_: torch.mean((m(g_)[:, 0] - t_) ** 2)
        for init in ("jax", "own"):
            model = port.SEGNN(ins, hid, outs, device=dev,
                               generator=torch.Generator().manual_seed(seed), **mkw)
            if init == "jax":
                params_from_jax(model, jax_tree(which))
            step = make_train_step(model, loss_fn, torch.optim.Adam(model.parameters(), lr=lr))
            t0 = time.perf_counter()
            for _ in range(steps):
                m = step(*batch)
            row = dict(steps=steps, train_loss=m["loss"].item(),
                       seconds=time.perf_counter() - t0)
            if which == "nbody":
                g_e, v_e, t_e = nbody_batch(16, 1)
                with torch.no_grad():
                    row["eval_mse"] = torch.mean((model(g_e, v_e) - t_e) ** 2).item()
                row["predict_zero_mse"] = torch.mean(t_e ** 2).item()
                row["passes"] = (row["train_loss"] < 0.009 and row["eval_mse"] < 0.011
                                 and row["eval_mse"] < 0.2 * row["predict_zero_mse"])
            else:
                row["target_var"] = batch[1].var(unbiased=False).item()
                row["passes"] = row["train_loss"] < 0.16
            out[f"{which}_{init}_init"] = row
        check(out[f"{which}_jax_init"]["passes"],
              f"{which} accuracy gate from JAX's initial weights: {out[f'{which}_jax_init']}")
    emit("coo_gates", card=card, gates=dict(
        nbody="train loss < 0.009, held-out MSE < 0.011 and < 0.2 x predict-zero",
        qm9="train loss < 0.16"), checked="jax_init rows; own_init rows are readings",
         **out)
    return out


# the user entry points (python -m scalable_e3_gnn_torch), driven in-process
CLI_STEPS = {"cloud100k": 5, "cloud1m": 3, "cloud10m": 3, "nbody": 3, "qm9": 3}
CLI_EVAL_FILES = 40  # tests/test_qm9.py's synthetic dsgdb9nsd download
CLI_EVAL_ARGS = ["--steps", "4", "--batch-size", "8"]
CLOUD_RESULT_KEYS = ["config", "final_loss", "steps", "edges"]  # + eval_mse to 500k points
APPROX2_RECALL = 0.85  # bench.py's approx_recall, held as the recall floor
APPROX2_SLACK = 1.02  # an approx2 edge may reach 1.02 r: bf16 keys at the cutoff


def write_qm9_download(path: Path, files: int) -> None:
    """``files`` synthetic molecules in the dsgdb9nsd .xyz format (the
    property line tab-separated, one Fortran-notation float) and an
    ``uncharacterized.txt`` listing molecules 3 and 7, as
    tests/test_qm9.py writes them."""
    from scalable_e3_gnn_torch.data.qm9 import _random_molecule

    rng = np.random.default_rng(0)
    for idx in range(1, files + 1):
        m = _random_molecule(rng, min_atoms=3, max_atoms=9)
        props = [f"{rng.uniform(100, 800):.5f}"] * 3 + [
            f"{rng.uniform(0, 3):.4f}", f"{rng.uniform(6, 35):.2f}",
            f"{-rng.uniform(0.2, 0.4):.4f}", f"{rng.uniform(0.0, 0.2):.4f}",
            f"{rng.uniform(0.2, 0.5):.4f}", f"{rng.uniform(19, 36):.4f}",
            f"{rng.uniform(0.02, 0.05):.6f}", f"{m['target']:.6f}",
            f"{m['target'] + 0.003:.6f}", f"{m['target'] + 0.004:.6f}",
            f"{m['target'] - 0.02:.6f}", f"{rng.uniform(6, 7):.3f}"]
        n = len(m["species"])
        lines = [str(n), f"gdb {idx}\t" + "\t".join(props) + "\t"]
        for i in range(n):
            x, y, z = m["positions"][i]
            zs = f"{z:.10f}" if i else "8.001*^-6"
            lines.append(f"{'HCNOF'[m['species'][i]]}\t {x:.10f}\t {y:.10f}\t {zs}\t "
                         f"{rng.uniform(-0.5, 0.5):.6f}")
        lines += ["1341.307\t2161.77\t", "C\tC\t", "InChI=1S/test\tInChI=1S/test"]
        (path / f"dsgdb9nsd_{idx:06d}.xyz").write_text("\n".join(lines) + "\n")
    (path / "uncharacterized.txt").write_text(
        "list of molecules that failed consistency\n\n"
        "  3   text text\n  7   text text\n\n3054 molecules\n")


def cli_run(argv, profile_step: int = -1) -> dict:
    """``scalable_e3_gnn_torch.cli.main(argv)`` in this process, on the card,
    every launch count zeroed just before and read just after; the runner's
    pieces wrapped to read, without changing what they compute: each train
    step (CUDA events around it, its launches; step ``profile_step`` under
    torch.profiler, read by ``profile_summary``), each cloud graph build
    (host clock around synchronised work, the graph kept), the cloud model's
    ladder.  The CLI's output is captured (its last line is the result)."""
    from torch.profiler import ProfilerActivity, profile

    import contextlib
    import io

    from scalable_e3_gnn_torch import cli
    from scalable_e3_gnn_torch.train import runners

    steps, builds, ladders, profiled = [], [], [], {}
    orig = {k: getattr(runners, k) for k in ("make_train_step", "_cloud_graph", "_cloud_model")}

    def make_train_step(*a, **kw):
        step = orig["make_train_step"](*a, **kw)

        def timed(*batch):
            before = launch_counts()
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            traced = len(steps) == profile_step
            if traced:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    m = step(*batch)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                profiled.update(profile_summary(prof, 1, wall, top=16))
            else:
                ev[0].record()
                m = step(*batch)
                ev[1].record()
            torch.cuda.synchronize()
            steps.append(dict(ms=None if traced else ev[0].elapsed_time(ev[1]),
                              launches={k: v - before[k] for k, v in launch_counts().items()
                                        if v - before[k]},
                              peak_gb=torch.cuda.max_memory_allocated() / 1e9))
            return m

        return timed

    def cloud_graph(*a, **kw):
        out, ms = sync_time(lambda: orig["_cloud_graph"](*a, **kw))
        builds.append(dict(ms=ms, graph=out[0], peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        return out

    def cloud_model(*a, **kw):
        ladders.append(kw)
        return orig["_cloud_model"](*a, **kw)

    buf = io.StringIO()
    runners.make_train_step, runners._cloud_graph = make_train_step, cloud_graph
    runners._cloud_model = cloud_model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(argv))
        torch.cuda.synchronize()
    finally:
        for k, v in orig.items():
            setattr(runners, k, v)
    wall_ms = (time.perf_counter() - t0) * 1e3
    total = launch_counts()
    in_steps = {k: sum(s["launches"].get(k, 0) for s in steps) for k in total}
    return dict(rc=rc, result=json.loads(buf.getvalue().strip().splitlines()[-1]),
                steps=steps, builds=builds, ladders=ladders, profile=profiled, wall_ms=wall_ms,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                outside_steps={k: total[k] - in_steps[k] for k in total
                               if total[k] - in_steps[k]})


def cli_cloud_phase(card: str, config: str, per_step: dict, held_out, ladder: dict,
                    profile_last: bool = False) -> dict:
    """``python -m scalable_e3_gnn_torch train --config <config> --steps S``
    at the config's full size: the result line's keys, finite and falling
    losses, the cloud model's ladder, the hand kernels' launches in every
    step equal to ``per_step`` and outside the steps to ``held_out`` (the
    launches of the held-out cloud's forward; None: the runner keeps no
    held-out cloud); step ms, graph build ms, peak memory; with
    ``profile_last``, a torch.profiler trace of the last step (device time
    per kernel, busy share)."""
    steps = CLI_STEPS[config]
    with tempfile.TemporaryDirectory() as tmp:
        log = f"{tmp}/m.jsonl"
        r = cli_run(["train", "--config", config, "--steps", str(steps), "--log", log],
                    profile_step=steps - 1 if profile_last else -1)
        recs = read_log(log)
    res = r["result"]
    losses = [rec["loss"] for rec in recs if "loss" in rec]
    keys = CLOUD_RESULT_KEYS + ([] if held_out is None else ["eval_mse"])
    eval_launches = held_out or {}
    want = {k: v for k, v in expected(per_step).items() if v}
    out = dict(card=card, argv=["train", "--config", config, "--steps", str(steps)],
               result=res, losses=losses, step_ms_events=[st["ms"] for st in r["steps"]],
               step_time_s_log=[rec["time_s"] for rec in recs if "loss" in rec],
               launches_per_step=[st["launches"] for st in r["steps"]],
               launches_outside_steps=r["outside_steps"],
               graph_build_ms=[b["ms"] for b in r["builds"]], ladder=r["ladders"],
               peak_mem_gb=r["peak_mem_gb"],
               peak_mem_gb_after=dict(graph=[b["peak_gb"] for b in r["builds"]],
                                      steps=[st["peak_gb"] for st in r["steps"]]),
               wall_ms=r["wall_ms"])
    if profile_last:
        out["profile_last_step"] = r["profile"]
    emit(f"cli_{config}", **out)
    check(r["rc"] == 0 and list(res) == keys, f"cli {config}: rc {r['rc']}, keys {list(res)}")
    check(len(losses) == steps and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0], f"cli {config}: losses {losses}")
    check(r["ladders"] == [dict(use_pallas=True, **ladder)],
          f"cli {config}: model ladder {r['ladders']}, expected {ladder} with the kernels")
    check(len(r["steps"]) == steps and all(st["launches"] == want for st in r["steps"]),
          f"cli {config}: launches per step {out['launches_per_step']}, expected {want}")
    check(r["outside_steps"] == eval_launches,
          f"cli {config}: launches outside the steps {r['outside_steps']}, "
          f"expected {eval_launches}")
    out["graph"] = r["builds"][0]["graph"]
    return out


def entry_phases(card: str) -> dict:
    """Phases 52-56: the user entry points on the card, driven through
    ``scalable_e3_gnn_torch.cli.main`` as ``python -m scalable_e3_gnn_torch``
    runs them, each at its config's full size.

    52. cli_cloud100k -- ``train --config cloud100k --steps 5``: 100k points,
        r=0.04, K=24, symmetrized, lmax=1, bf16, remat; the untabled lmax=1
        kernels: per step 4 of #3, 4 of #5, 4 reductions; the held-out
        cloud's forward 4 of #3; eval_mse.
    53. cli_cloud1m -- ``train --config cloud1m --steps 3``: 1M points,
        r=0.02, K=16, symmetrized, lmax=2, remat_kernel, full attributes in
        bf16; the sym-regather entry: per step 4 of #11, 4 of #13, 4 of its
        weight-gradient kernel and 4 reductions.
    54. cli_cloud10m -- ``train --config cloud10m --steps 3``: 10M points,
        r=0.01, K=16, the segmented "approx" build (10 segments), not
        symmetrized, 25 node blocks of 400k, remat_kernel, remat_layers=2,
        chunked bf16 attributes; per step, with L = 4 layers and C = 25
        blocks, #3 3 L C = 300 (the forward, the layer pair's recompute,
        each block's own recompute), #5 L C = 100, 100 reductions; the
        last step traced by torch.profiler (device time per kernel).  Then
        kernel_km_10m: #3 and #5 against their plain versions at the first
        block's shapes (400k receivers of the 10M graph, tile 160), bf16,
        with kernel_km's limits; times and bounds.
    55. cli_coo -- ``train --config nbody --steps 3`` and ``--config qm9``:
        no hand kernel (every count 0), finite losses (N-body's falling: it
        steps on one batch; QM9 takes its batches in turn).
    56. cli_qm9_eval -- ``qm9-eval`` on 40 synthetic .xyz files (2 listed as
        uncharacterized), 4 steps of 8: no hand kernel, finite MAEs in meV.
    Returns the readings for the ``kernels`` line."""
    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    lc = lambda c: {fm.KM_FWD.name: 3 * NUM_LAYERS * c, fm.KM_BWD.name: NUM_LAYERS * c,
                    fm.TAB_BWD_REDUCE.name: NUM_LAYERS * c}
    out = {}
    out["cloud100k"] = cli_cloud_phase(
        card, "cloud100k",
        {fm.KM_FWD.name: NUM_LAYERS, fm.KM_BWD.name: NUM_LAYERS,
         fm.TAB_BWD_REDUCE.name: NUM_LAYERS},
        {fm.KM_FWD.name: NUM_LAYERS}, dict(edge_chunks=1, remat_kernel=False, remat_layers=0))
    check(out["cloud100k"]["graph"].reverse_slot is not None, "cloud100k: not symmetrized")
    del out["cloud100k"]["graph"]
    out["cloud1m"] = cli_cloud_phase(
        card, "cloud1m",
        {fmg.GENERIC_FWD.name: NUM_LAYERS, fmg.GENERIC_BWD_REP.name: NUM_LAYERS,
         fmg.GENERIC_TAB_BWD_WGRAD.name: NUM_LAYERS, fm.TAB_BWD_REDUCE.name: NUM_LAYERS},
        None, dict(edge_chunks=1, remat_kernel=True, remat_layers=0))
    del out["cloud1m"]["graph"]
    chunks = 25
    out["cloud10m"] = cli_cloud_phase(
        card, "cloud10m", lc(chunks), None,
        dict(edge_chunks=chunks, remat_kernel=True, remat_layers=2), profile_last=True)
    check(out["cloud10m"]["profile_last_step"]["device_ms_per_step"] > 0,
          "cloud10m: the profiler saw no device time")

    # ---- 54b. #3/#5 at one cloud10m block against their plain versions
    g10 = out["cloud10m"].pop("graph")
    from scalable_e3_gnn_torch.cli import _CLOUD_POINTS

    check(g10.reverse_slot is None and g10.num_nodes == _CLOUD_POINTS["cloud10m"],
          "cloud10m graph")
    n, c = g10.num_nodes, g10.num_nodes // chunks
    model = km_model(dev)
    with torch.no_grad():
        geo = model.compute_attributes_dense_chunked(g10.positions, g10.senders, g10.edge_mask,
                                                     dtype=bf)[3]
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    h_ext = torch.randn((n, model.hidden_irreps.dim), generator=gen, device=dev)
    cfg, args, ws, n_valid = km_inputs(model, g10.senders, geo, h_ext, 0, c, bf, gen)
    del h_ext, geo, g10
    d_agg = torch.randn(args[1].shape, generator=gen, device=dev).to(bf)
    km = out["km_10m"] = km_check("cloud10m_block", cfg, args, ws, n_valid, d_agg, times=True)
    t = km["times"]
    emit("kernel_km_10m", card=card, rows=c, k=cfg.k, tile=cfg.tile, valid_slots=n_valid,
         fwd_ms=t["fwd_ms"], bwd_ms=t["bwd_ms"], fwd_plain_ms=t["fwd_plain_ms"],
         bwd_plain_ms=t["bwd_plain_ms"], bounds=t["bounds"], bf16_ulps=km["bf16_ulps"],
         d_hs_vs_exact=km["compared"]["d_hs"])
    del cfg, args, d_agg, model

    # ---- 55. configs 1 and 2 through the CLI
    coo = {}
    for config in ("nbody", "qm9"):
        steps = CLI_STEPS[config]
        with tempfile.TemporaryDirectory() as tmp:
            r = cli_run(["train", "--config", config, "--steps", str(steps), "--log",
                         f"{tmp}/m.jsonl"])
            losses = [rec["loss"] for rec in read_log(f"{tmp}/m.jsonl") if "loss" in rec]
        coo[config] = dict(result=r["result"], losses=losses,
                           step_ms_events=[st["ms"] for st in r["steps"]],
                           launches=[st["launches"] for st in r["steps"]],
                           launches_outside_steps=r["outside_steps"], wall_ms=r["wall_ms"])
        check(r["rc"] == 0 and r["result"]["config"] == config
              and r["result"]["steps"] == steps, f"cli {config}: {r['result']}")
        # N-body steps on one batch, so its loss falls; QM9 takes its batches in turn
        check(len(losses) == steps and all(math.isfinite(v) for v in losses)
              and (config == "qm9" or losses[-1] < losses[0]), f"cli {config}: losses {losses}")
        check(all(not st["launches"] for st in r["steps"]) and not r["outside_steps"],
              f"cli {config}: hand kernels launched")
    emit("cli_coo", card=card, **coo)

    # ---- 56. the literature QM9 protocol through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        write_qm9_download(Path(tmp), CLI_EVAL_FILES)
        r = cli_run(["qm9-eval", "--data-dir", tmp, *CLI_EVAL_ARGS])
    res = r["result"]
    emit("cli_qm9_eval", card=card, argv=["qm9-eval", "--data-dir", "<40 files>",
                                          *CLI_EVAL_ARGS],
         result=res, step_ms_events=[st["ms"] for st in r["steps"]], wall_ms=r["wall_ms"],
         launches_outside_steps=r["outside_steps"])
    check(r["rc"] == 0 and res["protocol"] == "qm9" and res["unit"] == "meV"
          and res["n_excluded"] == 3 and res["n_train"] + res["n_val"] + res["n_test"] ==
          CLI_EVAL_FILES - 2, f"cli qm9-eval: {res}")
    check(all(math.isfinite(res[k]) for k in ("final_loss", "val_mae", "test_mae")),
          f"cli qm9-eval: non-finite {res}")
    check(all(not st["launches"] for st in r["steps"]) and not r["outside_steps"],
          "cli qm9-eval: hand kernels launched")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    emit("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())

    # ---- 2. build every kernel source
    t0 = time.perf_counter()
    built = build_libraries(sorted({kern.source_name for kern in ALL_KERNELS}))
    ptxas = [ln.strip() for b in built.values() for ln in b["log"].splitlines()
             if "registers" in ln or "spill" in ln or "Function properties" in ln
             or "Compiling entry function" in ln]
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         per_source={k: round(v["seconds"], 3) for k, v in built.items()}, ptxas=ptxas)

    # ---- 3. the config-3 graph
    pts = np.random.default_rng(SEED).random((N_POINTS, 3)).astype(np.float32)
    build_graph(pts)  # warm-up: allocator, sort and search kernels
    tree, cap, edges, graph, gtimes = build_graph(pts)
    n_edges = int(graph.edge_mask.sum())
    brute, brute_ms = sync_time(
        lambda: radius_graph_brute(tree.points, RADIUS, MAX_NEIGHBORS, device=dev))
    agree = edge_agreement(edges, brute, N_POINTS)
    emit("graph", points=N_POINTS, cell_capacity=cap, edges_cell=int(edges.num_edges),
         edges_brute=int(brute.num_edges), edges_symmetrized=n_edges,
         table_size=graph.gather_tab.shape[1], brute_ms=round(brute_ms, 3),
         radius_agreement=agree, tolerance=TOL_RADIUS_AGREE, card=card,
         **{k: round(v, 3) for k, v in gtimes.items()})
    check(agree >= TOL_RADIUS_AGREE, f"radius graph agreement {agree} < {TOL_RADIUS_AGREE}")
    del brute

    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = port.SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=NUM_LAYERS, layout="cm",
                       use_pallas=True, device=dev,
                       generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        attrs32 = model.compute_attributes_dense(graph)
    tabs = (graph.gather_rev_dense, graph.gather_rem_pos, graph.gather_rem_node)
    bf = torch.bfloat16

    # ---- 4. forward kernel vs plain at the main path's shapes
    kres = {}
    with torch.no_grad():
        for dtype, tol in ((torch.float32, TOL_KERNEL_FP32), (bf, TOL_KERNEL_BF16)):
            cfg, args, ws, n_valid = kernel_inputs(graph, attrs32, model.layers[0], dtype, gen)
            got = fm.fused_message_aggregate_tabled_fwd(cfg, *args, *ws).float()
            torch.cuda.synchronize()
            ref = fm.fused_message_aggregate_tabled_plain(cfg, *args, *ws).float()
            err = (got - ref).abs()
            if dtype == torch.float32:
                bad = int((err > tol * torch.clamp(ref.abs(), min=1.0)).sum())
                limit = f"{tol} * max(1, |ref|) elementwise; fp32 sums in another order"
            else:
                bad = int((err > tol * ref.abs().max()).sum())
                limit = f"{tol} * max|ref|; bf16 rounding of layer-1 outputs and slot messages"
            max_err = float(err.max())
            kres[dtype] = dict(cfg=cfg, args=args, ws=ws, n_valid=n_valid, max_abs_err=max_err)
            emit("kernel", kernel=fm.TAB_FWD.name, dtype=str(dtype).replace("torch.", ""),
                 rows=args[0].shape[0], k=cfg.k, tile=cfg.tile, u=cfg.u, valid_slots=n_valid,
                 max_abs_err=max_err, max_rel_err=max_err / max(float(ref.abs().max()), 1e-30),
                 max_abs_ref=float(ref.abs().max()), elements_over_tolerance=bad,
                 tolerance=limit, finite=bool(torch.isfinite(got).all()),
                 bf16_ulps=None if dtype == torch.float32 else ulps_reading(got, ref))
            check(bad == 0 and bool(torch.isfinite(got).all()),
                  f"kernel vs plain in {dtype}: {bad} elements over tolerance")
        del got, ref, err

    # ---- 5. backward kernels vs plain, same inputs and a random cotangent
    names = ("d_h", "d_w0e1", "d_w1o1", "d_w0e2", "d_w1o2")
    part_names = ("d_hu", "d_hr", "dW0a", "dW1Sa", "dW1Va", "dW0b", "dW1Sb", "dW1Vb")
    with torch.no_grad():
        for dtype in (torch.float32, bf):
            kr = kres[dtype]
            cfg, args, ws = kr["cfg"], kr["args"], kr["ws"]
            ws6 = fm.split_weights(cfg, *ws)
            d_agg = torch.randn(args[0].shape, generator=gen, device=dev).to(dtype)
            kr["d_agg"] = d_agg
            fp32 = dtype == torch.float32
            # the kernels' own outputs: d_hu, d_hr and the reduced weight blocks
            d_hu, d_hr, partials = fm.tab_bwd_kernel(cfg, *args, ws6, d_agg)
            dw = fm.tab_bwd_reduce(partials)
            torch.cuda.synchronize()
            dw_ref = fm.tab_bwd_reduce_plain(partials)
            red = compare(dw, dw_ref, float(dw_ref.abs().max()), TOL_REDUCE)
            check(red[1] == 0, f"weight-gradient reduction vs plain: {red}")
            pieces, off = [], 0
            for a, b in cfg.weight_shapes():
                pieces.append(dw[off:off + a * b].view(a, b))
                off += a * b
            ref_parts = fm.tab_bwd_plain(cfg, *args, ws6, d_agg)
            ref_parts = list(ref_parts[:2]) + list(ref_parts[2])
            parts = {}
            for nm, x, y in zip(part_names, [d_hu, d_hr, *pieces], ref_parts, strict=True):
                ym = float(y.float().abs().max())
                scale = (torch.clamp(y.float().abs(), min=1.0) if fp32 and nm in ("d_hu", "d_hr")
                         else ym)
                parts[nm] = compare(x, y, scale, TOL_BWD_FP32 if fp32 else TOL_BWD_BF16)
            # the full backward: kernels + epilogue against the plain backward
            got = fm.fused_message_aggregate_tabled_bwd(cfg, *args, *tabs, *ws, d_agg)
            again = fm.fused_message_aggregate_tabled_bwd(cfg, *args, *tabs, *ws, d_agg)
            torch.cuda.synchronize()
            identical = all(torch.equal(x, y) for x, y in zip(got, again))
            ref = fm.fused_message_aggregate_tabled_bwd_plain(cfg, *args, *tabs, *ws, d_agg)
            full = {}
            for nm, x, y in zip(names, got, ref, strict=True):
                ym = float(y.float().abs().max())
                scale = torch.clamp(y.float().abs(), min=1.0) if fp32 and nm == "d_h" else ym
                full[nm] = compare(x, y, scale, TOL_BWD_FP32 if fp32 else TOL_BWD_BF16)
            finite = all(bool(torch.isfinite(x).all()) for x in (*got, d_hu, d_hr, dw))
            readings = None if fp32 else {
                nm: ulps_reading(x, y) for nm, x, y in
                zip((*part_names, *names), (d_hu, d_hr, *pieces, *got), (*ref_parts, *ref))}
            kr["bwd_max_abs_err"] = max(v[0] for v in parts.values())
            kr["reduce_max_abs_err"] = red[0]
            kr["bwd_parts"] = (d_hu, d_hr, partials)
            emit("kernel_bwd", kernels=[fm.TAB_BWD.name, fm.TAB_BWD_REDUCE.name],
                 dtype=str(dtype).replace("torch.", ""), rows=args[0].shape[0],
                 valid_slots=kr["n_valid"], blocks=partials.shape[0],
                 kernel_outputs={k: dict(max_abs_err=v[0], over_tolerance=v[1], max_abs_ref=v[2])
                                 for k, v in parts.items()},
                 reduction=dict(max_abs_err=red[0], over_tolerance=red[1], max_abs_ref=red[2],
                                tolerance=f"{TOL_REDUCE} * max|ref|; fp32 sums over the "
                                          "blocks in another order"),
                 with_epilogue={k: dict(max_abs_err=v[0], over_tolerance=v[1], max_abs_ref=v[2])
                                for k, v in full.items()},
                 tolerance=(f"d_h, d_hu, d_hr: {TOL_BWD_FP32} * max(1, |ref|) elementwise; "
                            f"weights: {TOL_BWD_FP32} * max|ref| (fp32 sums over 2.4M slots "
                            "in another order)") if fp32 else
                 f"{TOL_BWD_BF16} * max|ref|; bf16 rounding of the cotangent intermediates",
                 bit_identical_reruns=identical, finite=finite, bf16_ulps=readings)
            bad = {k: v[1] for k, v in {**parts, **full}.items() if v[1]}
            check(not bad and finite, f"backward kernels vs plain in {dtype}: {bad}")
            check(identical, f"two backward runs differ in {dtype}")
            del got, again, ref, ref_parts

    # ---- 6. the config-3 forward through the kernel (bf16), counted
    model_bf = copy.deepcopy(model).to(bf)
    attrs_bf = tuple(a.to(bf) for a in attrs32)
    graph_bf = graph._replace(nodes=graph.nodes.to(bf))
    fwd = lambda: model_bf(graph_bf, attrs=attrs_bf)
    with torch.no_grad():
        reset_launches()
        out = fwd()
        torch.cuda.synchronize()
        fwd_launches = launch_counts()
        check(fwd_launches == expected({fm.TAB_FWD.name: NUM_LAYERS}),
              f"{fwd_launches} kernel launches in one forward, expected {NUM_LAYERS} forward")
        check(tuple(out.shape) == (N_POINTS, 3), f"output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "non-finite output")

        # the same (bf16) weights in fp32: through the kernel and through the plain path
        model32 = port.SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=NUM_LAYERS, layout="cm",
                             use_pallas=True, device=dev)
        model32.load_state_dict({k: v.float() for k, v in model_bf.state_dict().items()})
        plain32 = port.SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=NUM_LAYERS, layout="cm",
                             use_pallas=False, device=dev)
        plain32.load_state_dict(model32.state_dict())
        ref = plain32(graph, attrs=attrs32)
        k32 = model32(graph, attrs=attrs32)
        scale = float(ref.abs().max())
        err32 = float((k32 - ref).abs().max())
        errbf = float((out.float() - ref).abs().max())
        emit("forward", points=N_POINTS, layers=NUM_LAYERS, dtype="bfloat16",
             shape=list(out.shape), launches=fwd_launches, max_abs_ref=scale,
             fp32_kernel_vs_plain_max_abs_err=err32,
             fp32_tolerance=f"{TOL_FORWARD_FP32} * max(1, |ref|); fp32 sums in another order",
             bf16_kernel_vs_fp32_plain_max_abs_err=errbf,
             bf16_tolerance=f"{TOL_FORWARD_BF16} * max|ref|; bf16 storage through 4 layers")
        check(bool(((k32 - ref).abs() <= TOL_FORWARD_FP32 * torch.clamp(ref.abs(), min=1.0)).all()),
              f"fp32 forward: kernel vs plain max abs err {err32}")
        check(errbf <= TOL_FORWARD_BF16 * scale, f"bf16 forward vs fp32 plain: {errbf}")
        del ref, k32, out, model32
        # the same bf16 forward through the plain message path, for the times
        plain_bf = plain32.to(bf)
        fwd_plain = lambda: plain_bf(graph_bf, attrs=attrs_bf)
        del plain32

    # ---- 7. the config-3 train step: fp32 masters, bf16 compute, MSE, Adam
    target = torch.from_numpy(np.random.default_rng(SEED + 2).standard_normal(
        (N_POINTS, 3)).astype(np.float32)).to(dev)

    opt = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE, betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(model, bf16_loss, opt)
    losses, norms, per_step = [], [], []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        before = launch_counts()
        m = step(graph_bf, attrs_bf, target)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        per_step.append({k: v - before[k] for k, v in launch_counts().items()})
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = launch_counts()
    want = expected({fm.TAB_FWD.name: NUM_LAYERS, fm.TAB_BWD.name: NUM_LAYERS,
                     fm.TAB_BWD_REDUCE.name: NUM_LAYERS})
    masters = all(p.dtype == torch.float32 for p in model.parameters())
    emit("train", points=N_POINTS, layers=NUM_LAYERS, steps=TRAIN_STEPS,
         compute_dtype="bfloat16", master_dtype="float32" if masters else "mixed",
         optimizer=f"Adam(lr={LEARNING_RATE}, betas=(0.9, 0.999), eps=1e-8)", losses=losses,
         grad_norms=norms, launches=train_launches, launches_per_step=per_step,
         seconds_incl_first_step=train_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)
    check(all(math.isfinite(x) for x in losses + norms), f"non-finite loss or norm: {losses} {norms}")
    check(all(s == want for s in per_step), f"launches per step {per_step}, expected {want}")
    check(masters, "master weights are not all fp32")

    # ---- 8. fp32 gradients: kernels vs autograd through the plain path
    pts_gc = np.random.default_rng(SEED + 3).random((GC_POINTS, 3)).astype(np.float32)
    _, _, _, graph_gc, _ = build_graph(pts_gc, GC_RADIUS)
    m_k = port.SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=NUM_LAYERS, layout="cm",
                     use_pallas=True, device=dev, generator=torch.Generator().manual_seed(SEED))
    m_p = port.SEGNN("2x0e+1x1o", HIDDEN, "1x1o", num_layers=NUM_LAYERS, layout="cm",
                     use_pallas=False, device=dev)
    m_p.load_state_dict(m_k.state_dict())
    with torch.no_grad():
        attrs_gc = m_k.compute_attributes_dense(graph_gc)
    t_gc = torch.from_numpy(np.random.default_rng(SEED + 4).standard_normal(
        (GC_POINTS, 3)).astype(np.float32)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    loss_k = mse_loss(m_k(graph_gc, attrs=attrs_gc), t_gc)
    loss_k.backward()
    loss_p = mse_loss(m_p(graph_gc, attrs=attrs_gc), t_gc)
    loss_p.backward()
    worst, worst_name = 0.0, ""
    for (nm, a), b in zip(m_k.named_parameters(), m_p.parameters(), strict=True):
        rel = float((a.grad - b.grad).abs().max()) / max(float(b.grad.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, nm
    emit("grad_check", points=GC_POINTS, radius=GC_RADIUS, k=MAX_NEIGHBORS, tile=TILE,
         layers=NUM_LAYERS, dtype="float32",
         edges_symmetrized=int(graph_gc.edge_mask.sum()), loss_kernel=loss_k.item(),
         loss_plain=loss_p.item(), worst_param=worst_name, worst_rel_err=worst,
         tolerance=f"{TOL_GRAD_FP32} * max|ref| per parameter; fp32 sums in another order",
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(worst <= TOL_GRAD_FP32, f"fp32 gradients: {worst_name} off by {worst} of max|ref|")
    check(abs(loss_k.item() - loss_p.item()) <= 1e-5 * loss_p.item(), "losses differ")
    del m_k, m_p, graph_gc, attrs_gc, loss_k, loss_p

    # ---- 9. forward times (CUDA events after warm-up)
    kb = kres[bf]
    cfg, args, ws = kb["cfg"], kb["args"], kb["ws"]
    with torch.no_grad():
        fwd_ms = event_ms(fwd, iters=10)
        fwd_plain_ms = event_ms(fwd_plain, iters=3, warmup=1)
        kern_ms = event_ms(lambda: fm.fused_message_aggregate_tabled_fwd(cfg, *args, *ws),
                           iters=20)
        plain_ms = event_ms(lambda: fm.fused_message_aggregate_tabled_plain(cfg, *args, *ws),
                            iters=5, warmup=1)
    del fwd_plain, plain_bf
    # bound: each input read once, the output written once; the products of
    # the valid slots at the bf16 tensor-core peak
    fwd_flops = 2 * messages_per_slot(cfg) * kb["n_valid"]
    fwd_bytes = nbytes(*args, *ws) + nbytes(args[0])
    fwd_bound, fwd_by, fwd_b_ms, fwd_o_ms = bound(fwd_bytes, fwd_flops)
    emit("times", card=card, forward_ms=fwd_ms, forward_plain_path_ms=fwd_plain_ms,
         kernel_ms_per_launch=kern_ms, kernel_ms_per_forward=kern_ms * NUM_LAYERS,
         plain_ms_per_call=plain_ms, bound_ms=fwd_bound, bound_bytes_ms=fwd_b_ms,
         bound_ops_ms=fwd_o_ms, kernel_gflop=fwd_flops / 1e9, kernel_mbytes=fwd_bytes / 1e6,
         kernel_fp32_fma_bound_ms=fwd_flops / PEAK_FP32_FMA_FLOPS * 1e3,
         graph_build_ms=sum(gtimes.values()), **{k: gtimes[k] for k in gtimes})

    # ---- 10. train-step and backward times (CUDA events after warm-up)
    step_ms = event_ms(lambda: step(graph_bf, attrs_bf, target), iters=5, warmup=1)
    ws6 = fm.split_weights(cfg, *ws)
    d_agg = kb["d_agg"]
    d_hu, d_hr, partials = kb["bwd_parts"]
    with torch.no_grad():
        bwd_ms = event_ms(lambda: fm.tab_bwd_kernel(cfg, *args, ws6, d_agg), iters=5, warmup=1)
        bwd_plain_ms = event_ms(lambda: fm.tab_bwd_plain(cfg, *args, ws6, d_agg),
                                iters=2, warmup=1)
        bwd_full_plain_ms = event_ms(lambda: fm.fused_message_aggregate_tabled_bwd_plain(
            cfg, *args, *tabs, *ws, d_agg), iters=2, warmup=1)
        epi_ms = event_ms(lambda: fm.sender_epilogue(d_hr, d_hu, *tabs), iters=10)
        bwd_full_ms = event_ms(lambda: fm.fused_message_aggregate_tabled_bwd(
            cfg, *args, *tabs, *ws, d_agg), iters=5, warmup=1)
    # bound of the main backward kernel: its inputs read once, d_hu, d_hr and
    # the weight gradients written once; the recompute (1x) and the VJP (2x)
    # products of the valid slots at the bf16 tensor-core peak
    nw = partials.shape[1]
    bwd_flops = 2 * 3 * messages_per_slot(cfg) * kb["n_valid"]
    bwd_bytes = nbytes(*args, *ws6, d_agg, d_hu, d_hr) + 4 * nw
    bwd_bound, bwd_by, bwd_b_ms, bwd_o_ms = bound(bwd_bytes, bwd_flops)
    emit("train_times", card=card, points=N_POINTS, step_ms=step_ms,
         bwd_kernel_ms_per_launch=bwd_ms, bwd_kernel_ms_per_step=bwd_ms * NUM_LAYERS,
         bwd_plain_ms_per_call=bwd_plain_ms, epilogue_ms=epi_ms, bwd_with_epilogue_ms=bwd_full_ms,
         bwd_with_epilogue_plain_ms=bwd_full_plain_ms, bwd_bound_ms=bwd_bound,
         bwd_bound_bytes_ms=bwd_b_ms, bwd_bound_ops_ms=bwd_o_ms,
         bwd_gflop=bwd_flops / 1e9, bwd_mbytes=bwd_bytes / 1e6,
         bwd_fp32_fma_bound_ms=bwd_flops / PEAK_FP32_FMA_FLOPS * 1e3,
         valid_slots=kb["n_valid"])

    # ---- 10b. the weight-gradient reduction at its three shapes, device times
    red3 = reduce_phase(card, partials)[0]

    # ---- 11. where a train step's device time goes
    prof = profile_steps(step, (graph_bf, attrs_bf, target))
    emit("profile", card=card, points=N_POINTS, **prof)
    check(prof["device_ms_per_step"] > 0, "the profiler saw no device time")

    # ---- 12-15. the lmax=2 config-4 proxy: graph, kernel #8, forward, times
    l2, l2ctx = lmax2_phases(card)

    # ---- 16-20. lmax=2 training: #9 at 250k, #10 at 1M
    l2t = lmax2_train_phases(card, l2ctx)

    # ---- 21-23. the untabled paths at 250k (#11 save, #12) and 1M (#11, #13)
    l2u = untabled_phases(card, l2ctx)

    # ---- 38-43. the fallback backward #14: replay_bwd=False at 250k and 1M,
    #      the lmax_attr=5 model
    vj = vjp_phases(card, l2ctx)
    del l2ctx

    # ---- 24-27. config 5: 10M points, edge_chunks, remat_layers (#11, #13)
    c5 = config5_phases(card)

    # ---- 28-33. the untabled lmax=1 path (#3, #5): config 3 without tables,
    #      the point-cloud example at 100k and at 1M (edge_chunks=8)
    km = km_phases(card, graph)

    # ---- 34-37. the packed lmax=1 path (#6, #7): SEGNN(pack=p) on config 3
    #      without tables
    pk = pack_phases(card, graph)

    # ---- 44-49. the dense partitioned path (#3/#5, #11/#12 per block) and
    #      the halo ring #15
    dr = dist_phases(card, graph)
    dp, procs_ctx = dist_procs_phase(card, graph)
    del graph
    dist_lmax2_phase(card)

    # ---- 49c-49e. the COO partitioned path, dp over clouds on the dense
    #      path (one process and 4 processes), the overlapped exchange
    cd = coo_dist_phase(card)
    dpl = dp_phases(card)

    # ---- 49f. kernel #15 between processes on the card, on both paths
    rp = ring_procs_phase(card, procs_ctx, dpl.pop("ctx"), cd)
    del procs_ctx

    # ---- 50-51. configs 1 and 2 on the COO path, through the runners
    for which in ("nbody", "qm9"):
        coo_phase(card, which)
    coo_gates(card)

    # ---- 52-56. the user entry points: python -m scalable_e3_gnn_torch
    ent = entry_phases(card)
    entry = lambda kern, *names: {nm: ent[nm]["launches_per_step"][0].get(kern.name, 0)
                                  for nm in names}

    src = lambda kern: str(kern.source.relative_to(Path(__file__).resolve().parent))
    print(json.dumps({"kernels": [
        {"name": fm.TAB_FWD.name, "route": "cuda", "source": src(fm.TAB_FWD),
         "replaces": f"{TPU_FILE}:401", "launches": train_launches[fm.TAB_FWD.name],
         "max_abs_err": kb["max_abs_err"], "ms": kern_ms, "plain_ms": plain_ms,
         "bound_ms": fwd_bound, "bound_by": fwd_by, "library_ms": None},
        {"name": fm.TAB_BWD.name, "route": "cuda", "source": src(fm.TAB_BWD),
         "replaces": f"{TPU_FILE}:513", "launches": train_launches[fm.TAB_BWD.name],
         "max_abs_err": kb["bwd_max_abs_err"], "ms": bwd_ms, "plain_ms": bwd_plain_ms,
         "bound_ms": bwd_bound, "bound_by": bwd_by, "library_ms": None},
        {"name": fm.TAB_BWD_REDUCE.name, "route": "cuda", "source": src(fm.TAB_BWD_REDUCE),
         "replaces": f"{TPU_FILE}:485", "launches": train_launches[fm.TAB_BWD_REDUCE.name],
         "max_abs_err": kb["reduce_max_abs_err"], "ms": red3["ms"],
         "plain_ms": red3["torch_sum_ms"], "bound_ms": red3["bound_ms"],
         "bound_by": red3["bound_by"], "library_ms": red3["torch_sum_ms"],
         "shape": red3["shape"], "times": "device time from torch.profiler",
         "event_ms": red3["event_ms"]["kernel"],
         "launches_per_rank_step_dist_procs": dp[fm.TAB_BWD_REDUCE.name],
         "launches_per_step_dp": dpl["one_process"].get(fm.TAB_BWD_REDUCE.name, 0),
         "launches_per_rank_step_dp": dpl["per_rank"].get(fm.TAB_BWD_REDUCE.name, 0)},
        {"name": fmg.GENERIC_TAB_FWD.name, "route": "cuda", "source": src(fmg.GENERIC_TAB_FWD),
         "replaces": f"{GENERIC_TPU_FILE}:937", "launches": l2["launches"],
         "max_abs_err": l2["max_abs_err"], "ms": l2["ms"], "plain_ms": l2["plain_ms"],
         "bound_ms": l2["bound_ms"], "bound_by": l2["bound_by"], "library_ms": None},
    ] + [{"name": kern.name, "route": "cuda", "source": src(kern),
          "replaces": f"{GENERIC_TPU_FILE}:{line}", **l2t[kern.name]}
         for kern, line in ((fmg.GENERIC_TAB_BWD_RES, 998), (fmg.GENERIC_TAB_BWD_REP, 1082),
                            (fmg.GENERIC_TAB_BWD_WGRAD, 1044), (fmg.GENERIC_TAB_BWD_TABLE, 1032))]
      + [{"name": kern.name, "route": "cuda", "source": src(kern),
          "replaces": f"{GENERIC_TPU_FILE}:{line}", **row}
         for kern, line, row in (
             (fmg.GENERIC_FWD, 556, {**c5[fmg.GENERIC_FWD.name], "launches_per_step_entry":
                                     entry(fmg.GENERIC_FWD, "cloud1m")}),
             (fmg.GENERIC_BWD_RES, 802, l2u[fmg.GENERIC_BWD_RES.name]),
             (fmg.GENERIC_BWD_REP, 710, {**c5[fmg.GENERIC_BWD_REP.name], "launches_per_step_entry":
                                         entry(fmg.GENERIC_BWD_REP, "cloud1m")}))]
      + [{"name": kern.name, "route": "cuda", "source": src(kern),
          "replaces": f"{GENERIC_TPU_FILE}:{line}", **vj[key]}
         for kern, line, key in ((fmg.GENERIC_BWD_VJP, 617, fmg.GENERIC_BWD_VJP.name),
                                 (fmg.GENERIC_BWD_VJP_WGRAD, 674, fmg.GENERIC_BWD_VJP_WGRAD.name),
                                 (fmg.GENERIC_FWD, 556, "generic_fwd_attr36"))]
      + [{"name": kern.name, "route": "cuda", "source": src(kern),
          "replaces": f"{TPU_FILE}:{line}", **km[kern.name],
          "launches_per_step_entry": entry(kern, "cloud100k", "cloud10m"),
          "launches_per_rank_step_dist_procs": dp[kern.name],
          "launches_per_step_dp": dpl["one_process"].get(kern.name, 0),
          "launches_per_rank_step_dp": dpl["per_rank"].get(kern.name, 0),
          "cloud10m_block": dict(
              max_abs_err=ent["km_10m"]["max_abs_err"][key],
              ms=ent["km_10m"]["times"][f"{key}_ms"],
              plain_ms=ent["km_10m"]["times"][f"{key}_plain_ms"],
              bound_ms=ent["km_10m"]["times"]["bounds"][key]["bound_ms"])}
         for kern, line, key in ((fm.KM_FWD, 1202, "fwd"), (fm.KM_BWD, 767, "bwd"))]
      + [{"name": kern.name, "route": "cuda", "source": src(kern),
          "replaces": f"{TPU_FILE}:{line}", **pk[kern.name]}
         for kern, line in ((fm.FLAT_FWD, 394), (fm.FLAT_BWD, 497))]
      + [{"name": hr.RING.name, "route": "cuda", "source": src(hr.RING),
          "replaces": f"{HALO_TPU_FILE}:43", **dr[hr.RING.name],
          "launches_per_step_coo_dist": cd["launches_per_step"],
          "ms_coo_dist_fp32": cd["ring_ms_fp32"],
          "launches_per_rank_step_ring_procs": rp["launches_per_rank_step"],
          "ms_ring_procs": rp["ms_between_processes"]}]
      + [{"name": kern.name, "route": "cuda", "source": src(kern),
          "replaces": f"{HALO_TPU_FILE}:43", **rp["rows"][kern.name],
          "launches_per_rank_step_ring_procs": rp["rows"][kern.name]["launches"]}
         for kern in (hr.IPC_PUBLISH, hr.IPC_GATHER)]
    }), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
