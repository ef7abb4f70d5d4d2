"""Multi-process execution: ``torch.distributed`` set-up and each rank's share.

Counterpart of ``scalable_e3_gnn_tpu/parallel/multihost.py``.  Every process
runs the same program; ``init_distributed`` joins them into one process group,
and each rank holds a contiguous, rank-major range of the spatial partitions
(``local_shard_slice``), so Morton-adjacent partitions stay on one rank except
at the rank boundaries.

The JAX module's ``make_hosts_mesh`` and ``global_put`` have no counterpart: a
process group takes the mesh's place, and each rank builds and holds only its
own partitions (``parallel.halo.shard_partitioned_dense``), never a global
array.  Data parallelism over clouds lays the ranks out dp-major, as JAX's
``(dp, graph)`` mesh: rank ``d * G + g`` is graph rank g of dp row d, and
each row exchanges halos within a process group of its own
(``dp_graph_group``).  With one process everything degenerates to the single-process path.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "dp_graph_group", "local_shard_slice", "rank_device",
           "world_size_and_rank", "card_identity", "card_identities", "check_one_card"]

DEFAULT_TIMEOUT_S = 60.0  # a dead peer fails a collective instead of hanging it


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: str = "gloo",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join this process to the default process group; a no-op for one process.

    The arguments default from PyTorch's own variables: ``WORLD_SIZE``,
    ``RANK`` and, for the rendezvous, ``MASTER_ADDR`` and ``MASTER_PORT``
    (``init_method`` e.g. ``"tcp://localhost:29500"`` replaces those two).
    ``backend`` is explicit: ``"gloo"`` runs on the CPU and for ranks that
    share one card (it takes the card's tensors and stages them through host
    memory itself).
    ``timeout_s`` bounds every collective, so a rank whose peer died raises
    instead of waiting for gloo's default 30 minutes.  Returns True iff a
    process group of more than one rank was initialised."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size <= 1:
        return False
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT")
        if port is None:
            raise ValueError("MASTER_PORT is not set and no init_method was given")
        init_method = f"tcp://{addr}:{port}"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def dp_graph_group(graph_ranks: int, timeout_s: float = DEFAULT_TIMEOUT_S):
    """``(group, row)``: the gloo process group of this rank's dp row (ranks
    ``row * graph_ranks`` to ``(row + 1) * graph_ranks - 1``) and the row.
    Every rank creates every row's group, in row order, as
    ``torch.distributed.new_group`` requires."""
    world, rank = world_size_and_rank()
    if graph_ranks < 1 or world % graph_ranks:
        raise ValueError(f"{world} ranks do not form rows of {graph_ranks}")
    mine = None
    for row in range(world // graph_ranks):
        ranks = list(range(row * graph_ranks, (row + 1) * graph_ranks))
        pg = dist.new_group(ranks, backend="gloo",
                            timeout=datetime.timedelta(seconds=timeout_s))
        if rank in ranks:
            mine = pg
    return mine, rank // graph_ranks


def world_size_and_rank(process_group=None) -> Tuple[int, int]:
    """(world size, rank) of ``process_group`` (the default group when None);
    (1, 0) when no process group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(process_group), dist.get_rank(process_group)


def local_shard_slice(num_parts: int, world_size: Optional[int] = None,
                      rank: Optional[int] = None) -> Tuple[int, int]:
    """``(lo, hi)``: the partitions this rank owns, contiguous and rank-major:
    rank r holds ``[r * num_parts // world_size, (r + 1) * num_parts //
    world_size)``.  ``world_size`` and ``rank`` default from the default
    process group (one process owns everything)."""
    if world_size is None or rank is None:
        ws, rk = world_size_and_rank()
        world_size = ws if world_size is None else world_size
        rank = rk if rank is None else rank
    if num_parts % world_size:
        raise ValueError(f"{num_parts} partitions do not divide over {world_size} ranks")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    per = num_parts // world_size
    return rank * per, (rank + 1) * per


def rank_device(device=None) -> torch.device:
    """The device of this rank: ``device`` when given (``"cpu"`` on the CPU),
    else ``cuda:(LOCAL_RANK % device_count)`` (``LOCAL_RANK`` defaults to
    ``RANK``).  Ranks outnumbering the cards share them: on one card every
    rank lands on ``cuda:0``.  Raises without a GPU and without ``device``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    return torch.device("cuda", local % torch.cuda.device_count())


def card_identity(device) -> str:
    """The UUID of ``device``'s card (``torch.cuda.get_device_properties``),
    which names one physical card whatever the process's device numbering."""
    return str(torch.cuda.get_device_properties(torch.device(device)).uuid)


def card_identities(device, process_group=None) -> list:
    """Every rank's ``card_identity``, gathered over ``process_group`` (the
    default group when None) in rank order; a collective of the group."""
    world, _ = world_size_and_rank(process_group)
    mine = card_identity(device)
    if world == 1:
        return [mine]
    out = [None] * world
    dist.all_gather_object(out, mine, group=process_group)
    return out


def check_one_card(identities) -> None:
    """Raise ``NotImplementedError`` unless every rank names the same card:
    the halo ring between processes maps its peers' memory on one card; across
    cards it needs peer-mapped pools (ROADMAP.md section 2, A3b)."""
    cards = sorted(set(identities))
    if len(cards) > 1:
        raise NotImplementedError(
            f"the ring (#15) between processes runs on one card shared by the ranks; these "
            f"ranks are on {len(cards)} cards ({cards}), which needs peer-mapped pools across "
            "cards (ROADMAP.md section 2, A3b); use backend='all_gather'")
