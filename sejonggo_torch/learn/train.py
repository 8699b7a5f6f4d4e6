"""Training step (port of sejonggo_tpu/learn/train.py).

Reference counterpart: train.py:24-72 (SGD lr 1e-2 momentum 0.9, batch
32, NUM_WORKERS=64 steps per epoch) and train.py:75-133's
keras.multi_gpu_model data parallelism, which the JAX package makes a
sharded jit over the 'dp' axis of a mesh and the port a step over the
ranks of a ``parallel.Mesh`` with explicit collectives.

L2: the reference regularizes every conv/dense kernel AND bias with
keras l2(1e-4) (model.py:23-26), i.e. a d(loss)/dw contribution of
2e-4 * w; replicated, as in the JAX package, as decoupled weight decay
2e-4 masked to exclude BatchNorm parameters (Keras does not regularize
those), followed by SGD with momentum: optax's
``chain(masked(add_decayed_weights(2 l2)), sgd(lr, momentum))``.

The optimiser works on flat float32 vectors (every parameter of the net
in ``net.parameters()`` order), so the whole update, the momentum trace
and the non-finite guard are a few tensor operations with no host sync:
  d = g + decay * w;  trace' = momentum * trace + d;  w' = w - lr * trace'
in optax's order of roundings.  The running BatchNorm statistics follow
flax (``nets/azero.py:fold_batch_stats``).
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Callable, Dict, Optional

import torch
from torch import nn

from sejonggo_torch.nets import az_loss, batch_norms, fold_batch_stats
from sejonggo_torch.parallel import replicate


@dataclasses.dataclass
class TrainState:
    """The train net (parameters and running BatchNorm statistics), the
    optimiser state (the flat momentum trace, optax's ``trace``) and the
    count of updates applied (0-d int32), all on the net's device."""

    net: nn.Module
    opt_state: torch.Tensor
    step: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SGD:
    """optax.chain(masked(add_decayed_weights(2 * l2), not BatchNorm),
    sgd(lr, momentum)): the hyper-parameters; the trace lives in
    ``TrainState.opt_state``."""

    lr: float = 1e-2
    momentum: float = 0.9
    l2: float = 1e-4


def _decay_mask(net: nn.Module) -> Dict[str, bool]:
    """{parameter name: decayed?}: every parameter except BatchNorm's
    (the JAX package masks the flax modules named BatchNorm_*; the port's
    BatchNorms are named stem_bn, bn1, ..., so it masks by type)."""
    in_bn = {id(p) for bn in batch_norms(net) for p in bn.parameters()}
    return {name: id(p) not in in_bn for name, p in net.named_parameters()}


def make_optimizer(lr: float = 1e-2, momentum: float = 0.9,
                   l2: float = 1e-4) -> SGD:
    return SGD(lr, momentum, l2)


class PlateauScheduler:
    """ReduceLROnPlateau (reference main_training.py:72, which monitors
    policy_out_acc; here the monitored metric is the per-phase mean
    training loss, mode=min).  After `patience` consecutive phases
    without improvement > `min_delta`, the LR is multiplied by `factor`
    (floored at `min_lr`) and the wait counter resets.

    Pure host-side bookkeeping: the caller rebuilds its train step when
    `update()` returns a new LR; the momentum trace carries over.
    """

    def __init__(self, lr: float, factor: float = 0.5, patience: int = 8,
                 min_lr: float = 1e-4, min_delta: float = 1e-3):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.min_delta = min_delta
        self.best = float("inf")
        self.wait = 0

    def update(self, metric: float) -> Optional[float]:
        """Feed one phase's metric; returns the new LR if it changed."""
        if not math.isfinite(metric):
            return None  # nonfinite phases don't count toward plateau
        if metric < self.best - self.min_delta:
            self.best = metric
            self.wait = 0
            return None
        self.wait += 1
        if self.wait < self.patience or self.lr <= self.min_lr:
            return None
        self.lr = max(self.lr * self.factor, self.min_lr)
        self.wait = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "wait": self.wait}

    def load_state_dict(self, d: dict) -> None:
        self.lr = d["lr"]
        self.best = d["best"]
        self.wait = d["wait"]


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _write(dst: list, flat: torch.Tensor) -> None:
    """Copy ``flat`` into the tensors ``dst`` (their order and sizes)."""
    parts = flat.split([t.numel() for t in dst])
    torch._foreach_copy_(dst, [p.view_as(t) for p, t in zip(parts, dst)])


def init_train_state(net: nn.Module, step: int = 0,
                     trace: Optional[torch.Tensor] = None) -> TrainState:
    """The state of ``net`` as it stands: a zero trace (optax's init)
    unless ``trace`` is given, ``step`` updates so far."""
    dev = next(net.parameters()).device
    if trace is None:
        trace = torch.zeros(sum(p.numel() for p in net.parameters()),
                            dtype=torch.float32, device=dev)
    return TrainState(net, trace.to(dev),
                      torch.tensor(step, dtype=torch.int32, device=dev))


def make_train_step(tx: SGD, loss_mode: str = "agz", mesh=None) -> Callable:
    """step(state, boards, policy_targets, value_targets) -> (state,
    metrics): one SGD update of ``state.net`` in place, on tensors on
    the net's device.  Metrics are 0-d device tensors: loss, policy_ce,
    value_mse, grad_norm and nonfinite (1.0 when the update was
    skipped).

    With a ``mesh`` of several ranks the step is the JAX package's
    sharded step over 'dp': each rank passes its even share of the global
    batch (``parallel.host_local_batch`` checks it: the mean of the
    ranks' means is the global mean only when the shards are equal).
    BatchNorm normalises with the global batch's statistics
    (``nets/azero.py:_norm``), the flat gradient is all-reduced once a
    step as a mean, and so are the loss metrics; the non-finite guard
    reads the reduced values, so every rank applies or skips the same
    update and the parameters stay identical by construction.  Rank 0's
    state is broadcast once, at the first step of each net."""
    decay = {}  # device -> flat decay vector (2 l2 where decayed, else 0)
    multi = mesh is not None and mesh.size > 1
    replicated = weakref.WeakSet()   # nets whose state came from rank 0

    def step_fn(state: TrainState, boards, policy_targets, value_targets):
        net = state.net
        params = list(net.parameters())
        dev = params[0].device
        if dev not in decay:
            mask = _decay_mask(net)
            decay[dev] = torch.cat([
                torch.full((p.numel(),), 2.0 * tx.l2 if mask[n] else 0.0,
                           device=dev)
                for n, p in net.named_parameters()])
        if multi and net not in replicated:
            replicate(state, mesh)
            replicated.add(net)
        logits, values, batch = net(boards, train=True,
                                    mesh=mesh if multi else None)
        total, metrics = az_loss(logits, values, policy_targets,
                                 value_targets, loss_mode)
        grads = torch.autograd.grad(total, params)
        with torch.no_grad():
            w, g = _flat(params), _flat(grads)
            metrics = {k: v.detach() for k, v in metrics.items()}
            if multi:
                g = mesh.mean(g)
                names = list(metrics)
                reduced = mesh.mean(torch.stack(
                    [metrics[k] for k in names] + [total.detach()]))
                metrics = dict(zip(names, reduced[:-1]))
                total = reduced[-1]
            gnorm = torch.linalg.vector_norm(g)
            trace = state.opt_state * tx.momentum + (g + decay[dev] * w)
            new_w = w + trace * (-tx.lr)
            stats = [t for bn in batch_norms(net)
                     for t in (bn.running_mean, bn.running_var)]
            old_stats = _flat(stats)
            new_stats = _flat(fold_batch_stats(
                net, [(m.detach(), v.detach()) for m, v in batch]))
            # Non-finite guard (reference TerminateOnNaN, train.py:34): a
            # NaN/inf loss or gradient skips the whole update — params,
            # batch stats and momentum keep their old values — and is
            # reported in metrics['nonfinite'].
            ok = torch.isfinite(total) & torch.isfinite(gnorm)
            _write(params, torch.where(ok, new_w, w))
            _write(stats, torch.where(ok, new_stats, old_stats))
            new_state = TrainState(net, torch.where(ok, trace, state.opt_state),
                                   state.step + ok.to(torch.int32))
        metrics.update(grad_norm=gnorm, nonfinite=(~ok).to(torch.float32))
        return new_state, metrics

    return step_fn
