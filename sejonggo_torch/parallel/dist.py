"""Process-group bootstrap (port of sejonggo_tpu/parallel/dist.py).

The JAX package joins jax's distributed runtime with one process per
host; jax.devices() then spans every chip and XLA inserts the
collectives.  The port runs one process per card, a rank, in a
``torch.distributed`` process group, and calls its collectives itself
(``parallel/mesh.py``).  A world of W ranks therefore plays like W JAX
hosts with one device each, the layout of the JAX package's own
multi-host test (tests/_mh_worker.py); the one JAX layout the port cannot
copy is a process that drives several devices.

The backend follows the device: NCCL when every rank of a machine has a
card of its own, gloo otherwise (ranks that share one card, or the CPU),
because NCCL refuses two ranks on one GPU.  Both carry the only
collectives the port uses: ``all_reduce``, ``broadcast`` and a barrier.
A rank finds its card from its local rank (torchrun's LOCAL_RANK, or
the pipeline's --local-rank); without one, only a world that fits this
machine's cards is placed.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from sejonggo_torch._device import resolve_device

_rank_device: Optional[torch.device] = None


def rank_device(device=None) -> torch.device:
    """The device this rank computes on: ``device`` when the caller names
    one, else the one chosen when the group was made, else CUDA.  CUDA is
    never replaced by the CPU: without a card it raises
    (``resolve_device``)."""
    if device is not None:
        return resolve_device(device)
    if _rank_device is not None:
        return _rank_device
    return resolve_device(None)


def card_layout(rank: int, world: int, local_rank: Optional[int],
                cards: int) -> tuple:
    """(card index, whether the card is this rank's own) for a rank that
    did not name its device, on a machine with ``cards`` cards.

    ``local_rank`` (the caller's, else torchrun's LOCAL_RANK) is the
    rank's card on its machine; torchrun's LOCAL_WORLD_SIZE says how many
    ranks the machine holds, and when that is more than a one-card
    machine has, every rank shares card 0.  Without either, the world is
    taken to be on this machine when it has a card for every rank.
    Anything else raises rather than stack ranks on one card and leave
    the others idle: a rank of a world on several machines needs its
    local rank, and ranks that mean to share a card name it
    (``device="cuda:0"``)."""
    env = local_rank is None and "LOCAL_RANK" in os.environ
    if env:
        local_rank = int(os.environ["LOCAL_RANK"])
        if int(os.environ.get("LOCAL_WORLD_SIZE", world)) > cards:
            if cards == 1:
                return 0, False
            raise ValueError(
                f"{os.environ.get('LOCAL_WORLD_SIZE')} ranks on a machine "
                f"of {cards} cards: start one rank per card")
    elif local_rank is None:
        if world > cards:
            raise ValueError(
                f"a world of {world} ranks and {cards} card(s) here: give "
                "each rank its card on its machine (--local-rank), or name "
                "one card for ranks that share it (--device cuda:0)")
        local_rank = rank
    if not 0 <= local_rank < cards:
        raise ValueError(f"local rank {local_rank} on a machine of "
                         f"{cards} card(s)")
    return local_rank, True


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device=None,
                     local_rank: Optional[int] = None,
                     timeout_s: float = 1800.0) -> int:
    """Join the process group; returns this process's rank.

    With ``num_processes`` > 1 the group meets at
    ``tcp://{coordinator_address}`` (host:port of rank 0) as rank
    ``process_id``.  Otherwise, when torchrun's ``WORLD_SIZE`` > 1 is set
    (as jax reads JAX_COORDINATOR_ADDRESS), it meets at
    ``MASTER_ADDR:MASTER_PORT`` as ``RANK``.  One process: a no-op that
    returns 0.

    The rank's device: None or "cuda" picks its own card
    (``card_layout``, from ``local_rank``) and NCCL; on a one-card
    machine that runs several ranks they all share card 0 over gloo.  A
    device named with its index, or "cpu", is taken as it is, with gloo
    (ranks named onto one card must not use NCCL).  It is set as the
    current CUDA device before the group exists, so NCCL's collectives
    find it; ``rank_device()`` returns it from then on.  A collective
    that waits longer than ``timeout_s`` raises: a rank that died ends
    the others instead of hanging them."""
    global _rank_device
    if dist.is_initialized():
        return dist.get_rank()
    if num_processes is not None and num_processes > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError("a multi-process group needs the coordinator's "
                             "host:port and this process's id")
        addr, world, rank = coordinator_address, num_processes, process_id
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return 0
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    dev = None if device is None else resolve_device(device)
    backend = "gloo"
    if dev is None or (dev.type == "cuda" and dev.index is None):
        resolve_device(None)              # raises without a card
        index, own = card_layout(rank, world, local_rank,
                                 torch.cuda.device_count())
        dev = torch.device("cuda", index)
        backend = "nccl" if own else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    _rank_device = dev
    return rank


def shutdown() -> None:
    """Leave the process group (if any)."""
    global _rank_device
    if dist.is_initialized():
        dist.destroy_process_group()
    _rank_device = None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def backend() -> Optional[str]:
    """The group's backend ("nccl" or "gloo"), None without a group."""
    return dist.get_backend() if dist.is_initialized() else None


def game_range(total_games: int, n: int, i: int) -> range:
    """Games of rank i of n: ceil(total / n) each, the last ranks the
    rest (the JAX package's ranges, sejonggo_tpu/parallel/dist.py)."""
    per = (total_games + n - 1) // n
    return range(i * per, min((i + 1) * per, total_games))


def local_game_slice(total_games: int) -> range:
    """Which games this rank owns (the reference's master-assigned
    game-number ranges, master_coordinator.py:120-157, become a
    deterministic split)."""
    return game_range(total_games, process_count(), process_index())


def rank_seed(seed: int) -> int:
    """This rank's generator seed: ``seed`` itself in a world of one,
    else a 63-bit number drawn from numpy's SeedSequence of (seed, rank).
    It is the port's form of ``jax.random.fold_in(key, process_index)``:
    every rank draws its own noise, symmetries and colours."""
    if process_count() == 1:
        return seed
    ss = np.random.SeedSequence([seed, process_index()])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))
