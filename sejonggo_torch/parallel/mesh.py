"""A data-parallel mesh of ranks (port of sejonggo_tpu/parallel/mesh.py).

In the JAX package a ``Mesh`` of devices carries the shardings and XLA
inserts the collectives: self-play games are a leading batch axis split
over 'dp', the learner's batch likewise with its gradients all-reduced,
and the weights are replicated.  Here a ``Mesh`` is this rank's place in
the process group (``parallel/dist.py``): its ``size`` and ``rank`` (so
that ``b % mesh.size`` reads as in JAX), the axis name and the device its
collectives run on.  The game and train batches are split by rank
(``shard_batch``), the weights are replicated by one broadcast from rank
0 (``replicate``), and the collectives are explicit: a sum or mean
all-reduce, a sum of counts, a barrier.  They use only ``all_reduce``
and ``broadcast`` on device tensors, which NCCL and gloo both carry
(gloo also for CUDA tensors), so a one-card gloo world and an NCCL world
run one code path.  A mesh of one rank (``local=True``, or a world of
one) makes every collective a no-op.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from sejonggo_torch.parallel.dist import (game_range, process_count,
                                          process_index, rank_device)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a 1-D data-parallel axis."""

    axis_name: str
    size: int
    rank: int
    device: torch.device

    def game_slice(self, total_games: int) -> range:
        """This rank's games of ``total_games`` (``local_game_slice``'s
        ranges over the mesh)."""
        return game_range(total_games, self.size, self.rank)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor; no gradient)."""
        if self.size == 1:
            return t
        out = t.detach().clone()
        dist.all_reduce(out)
        return out

    def all_reduce_sum_grad(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, differentiable: its backward
        sums the incoming gradients over the ranks too, so each rank's
        gradient is that of the sum of every rank's loss."""
        if self.size == 1:
            return t
        return _AllReduceSum.apply(t)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the ranks (equal on every rank)."""
        if self.size == 1:
            return t
        return self.all_reduce_sum(t) / self.size

    def sum_counts(self, counts: Sequence[float]) -> list:
        """Host numbers summed over the ranks (float64 on the device)."""
        if self.size == 1:
            return list(counts)
        t = torch.tensor(list(counts), dtype=torch.float64, device=self.device)
        dist.all_reduce(t)
        return t.tolist()

    def barrier(self) -> None:
        """Every rank waits here for the others (an all-reduce read back
        to the host: the same call on NCCL and on gloo)."""
        if self.size > 1:
            self.sum_counts([1.0])

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite ``tensors`` in place with rank 0's."""
        if self.size == 1:
            return
        for t in tensors:
            dist.broadcast(t.data, src=0)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out)
        return out


def make_mesh(dp: int = 0, axis_name: str = "dp", local: bool = False,
              device=None) -> Mesh:
    """The mesh of ``dp`` ranks (0 = every rank of the group).
    ``local=True`` gives this process alone: the actors' mesh, since a
    rank's games need nothing from the others.  A global mesh spans the
    whole group: the port makes no sub-groups, so ``dp`` must be 0 or the
    group's size."""
    dev = rank_device(device)
    if local:
        if dp not in (0, 1):
            raise ValueError(f"a local mesh holds this process's one "
                             f"device, not {dp}")
        return Mesh(axis_name, 1, 0, dev)
    world = process_count()
    if dp not in (0, world):
        raise ValueError(f"dp={dp} in a process group of {world} ranks: "
                         "the port runs one rank per device and no "
                         "sub-groups")
    return Mesh(axis_name, world, process_index(), dev)


def _rows(n: int, mesh: Mesh) -> slice:
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not split over "
                         f"{mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(arr, mesh: Mesh):
    """This rank's rows of ``arr`` (numpy array or tensor), its even
    share of the leading axis, as the same type on the same device."""
    return arr[_rows(arr.shape[0], mesh)]


def shard_actor_state(state, mesh: Mesh):
    """``shard_batch`` of every array leaf of an actor state or a move's
    draws (dataclasses, dicts, lists and tuples of arrays whose leading
    axis is the game batch).  None, Python numbers and 0-d arrays stay as
    they are (a draw shared by the batch, such as one symmetry)."""
    if state is None or isinstance(state, (int, float, bool, str)):
        return state
    if isinstance(state, (torch.Tensor, np.ndarray)):
        return state if state.ndim == 0 else shard_batch(state, mesh)
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{
            f.name: shard_actor_state(getattr(state, f.name), mesh)
            for f in dataclasses.fields(state)})
    if isinstance(state, dict):
        return {k: shard_actor_state(v, mesh) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(shard_actor_state(v, mesh) for v in state)
    raise TypeError(f"cannot shard a {type(state).__name__}")


def _tensors(tree) -> list:
    if isinstance(tree, nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree)
                for t in _tensors(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def replicate(tree, mesh: Mesh):
    """Rank 0's values in every tensor of ``tree`` (a module, a train
    state, a dict or list of tensors), in place by one broadcast each;
    returns ``tree``.  The port's form of placing a pytree replicated."""
    mesh.broadcast_(_tensors(tree))
    return tree


def host_local_batch(arr, mesh: Mesh, global_rows: int):
    """This rank's rows of a global batch of ``global_rows``, checked to
    be its even share: the mean over the ranks' means is the global
    batch's mean only when the shards are equal (the JAX package builds
    one global array from the hosts' rows instead,
    sejonggo_tpu/parallel/mesh.py:host_local_batch)."""
    if arr.shape[0] * mesh.size != global_rows:
        raise ValueError(f"{arr.shape[0]} local rows on each of {mesh.size} "
                         f"ranks do not make the global batch of "
                         f"{global_rows}")
    return arr
