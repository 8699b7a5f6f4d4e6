"""AlphaZero residual policy/value net as an ``nn.Module`` (port of
sejonggo_tpu/nets/azero.py).

Reference model.py:55-95: 3x3 conv + BN + ReLU stem, residual blocks of
two 3x3 conv + BN with a skip, a policy head (1x1 conv(2) + BN + ReLU ->
Linear(N*N+1)) and a value head (1x1 conv(2) + BN + ReLU -> Linear(hidden)
ReLU -> Linear(1) tanh).  BatchNorm keeps the Keras/flax settings
(eps 1e-3; flax momentum .99 is torch momentum 0.01).

The module computes in NCHW; its public input is NHWC (B, N, N, 17) like
the JAX package.  The heads permute back to NHWC before flattening,
because the flax Dense layers were trained on an NHWC flatten.

``compute_dtype`` follows flax's ``dtype=compute, param_dtype=float32``:
the parameters and BatchNorm statistics stay float32; convolutions, dense
layers and activations run in the compute dtype, and BatchNorm takes the
compute-dtype activations with its float32 statistics, normalises in
float32 and rounds its output once to the compute dtype, as flax's
``_normalize`` does (one pass over the activations).  The weights are cast
to the compute dtype once and the copy is kept until a weight changes.

``forward(boards, train=True)`` is flax's ``train=True`` apply:
BatchNorm normalises with the batch's own statistics, the biased
variance computed in float32 as mean(x²) − mean(x)² (flax's
``use_fast_variance``), and the forward also returns each BatchNorm's
batch (mean, var).  It writes no module state: the train step folds the
statistics into the running averages flax's way (``fold_batch_stats``),
only when its update is kept.  The mode is chosen per call, never by
``nn.Module.train()``/``eval()``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sejonggo_torch.config import NetConfig

BN_EPS = 1e-3
BN_MOMENTUM = 0.01


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


def _weights(layer: nn.Module, dtype: torch.dtype):
    """(weight, bias) of ``layer`` in ``dtype``.  Under autograd the cast
    is part of the graph.  Otherwise the cast copy is kept on the layer
    and made anew when a parameter has been written since (its
    ``_version`` moved: an optimiser step, ``load_state_dict``), has moved
    (its storage changed) or the dtype differs."""
    w, b = layer.weight, layer.bias
    if torch.is_grad_enabled() and w.requires_grad:
        return w.to(dtype), b.to(dtype)
    key = (dtype, w.data_ptr(), w._version, b.data_ptr(), b._version)
    cached = layer.__dict__.get("_cast_copy")
    if cached is None or cached[0] != key:
        with torch.no_grad():
            cached = (key, w.to(dtype), b.to(dtype))
        layer.__dict__["_cast_copy"] = cached
    return cached[1], cached[2]


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` in the dtype of ``x`` (float32 parameters)."""
    return F.conv2d(x, *_weights(conv, x.dtype), padding=conv.padding)


def _dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, *_weights(lin, x.dtype))


def _norm(bn: nn.BatchNorm2d, x: torch.Tensor, stats,
          mesh=None) -> torch.Tensor:
    """flax BatchNorm of ``x`` (in its compute dtype, float32 inside).
    ``stats`` None: the running statistics.  A list: the batch's own,
    appended to it as (mean, var).  With a ``mesh`` of several ranks the
    batch is the global one, split over the ranks, as in the JAX
    package's sharded step (where XLA inserts the collective): the
    per-channel sums of x and x² and the count are all-reduced in one
    differentiable collective."""
    if stats is None:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    xf = x.float()
    if mesh is None or mesh.size == 1:
        mean = xf.mean((0, 2, 3))
        meansq = (xf * xf).mean((0, 2, 3))
    else:
        c = xf.shape[1]
        count = xf.new_full((1,), xf.numel() // c)
        sums = mesh.all_reduce_sum_grad(torch.cat(
            [xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count]))
        mean, meansq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
    var = (meansq - mean * mean).clamp_min(0.0)
    stats.append((mean, var))
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None]
    return (y + bn.bias[:, None, None]).to(x.dtype)


def batch_norms(net: nn.Module) -> list:
    """The BatchNorm layers of ``net`` in the order its train-mode
    forward returns their batch statistics."""
    return [m for m in net.modules() if isinstance(m, nn.BatchNorm2d)]


def fold_batch_stats(net: nn.Module, batch_stats) -> list:
    """The running statistics flax keeps after a train-mode apply:
    [mean_0, var_0, mean_1, ...] with r <- 0.99 r + 0.01 batch (flax
    ``normalization.py``: the biased batch variance; torch's own
    BatchNorm would fold in the unbiased one)."""
    m = 1.0 - BN_MOMENTUM
    out = []
    for bn, (mean, var) in zip(batch_norms(net), batch_stats):
        out += [m * bn.running_mean + (1.0 - m) * mean,
                m * bn.running_var + (1.0 - m) * var]
    return out


class ResBlock(nn.Module):
    def __init__(self, filters: int):
        super().__init__()
        self.conv1 = nn.Conv2d(filters, filters, 3, padding=1)
        self.bn1 = _bn(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, padding=1)
        self.bn2 = _bn(filters)

    def forward(self, x, stats=None, mesh=None):
        y = F.relu(_norm(self.bn1, _conv(self.conv1, x), stats, mesh))
        y = _norm(self.bn2, _conv(self.conv2, y), stats, mesh)
        return F.relu(y + x)


class AZNet(nn.Module):
    """Policy/value tower.  Input: (B, N, N, 17) feature planes (NHWC)."""

    def __init__(self, size: int, blocks: int = 20, filters: int = 256,
                 value_hidden: int = 256, policy_filters: int = 2,
                 value_filters: int = 2, compute_dtype: str = "bfloat16"):
        super().__init__()
        self.size = size
        self.compute_dtype = getattr(torch, compute_dtype)
        a = size * size + 1
        self.stem_conv = nn.Conv2d(17, filters, 3, padding=1)
        self.stem_bn = _bn(filters)
        self.blocks = nn.ModuleList(ResBlock(filters) for _ in range(blocks))
        self.policy_conv = nn.Conv2d(filters, policy_filters, 1)
        self.policy_bn = _bn(policy_filters)
        self.policy_out = nn.Linear(policy_filters * size * size, a)
        self.value_conv = nn.Conv2d(filters, value_filters, 1)
        self.value_bn = _bn(value_filters)
        self.value_hidden = nn.Linear(value_filters * size * size, value_hidden)
        self.value_out = nn.Linear(value_hidden, 1)

    @classmethod
    def from_config(cls, size: int, cfg: NetConfig) -> "AZNet":
        return cls(size, blocks=cfg.blocks, filters=cfg.filters,
                   value_hidden=cfg.value_hidden,
                   policy_filters=cfg.policy_filters,
                   value_filters=cfg.value_filters,
                   compute_dtype=cfg.compute_dtype)

    @staticmethod
    def _flatten_nhwc(x):
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def forward(self, boards: torch.Tensor, train: bool = False, mesh=None):
        """(B, N, N, 17) -> (policy logits (B, N*N+1), values (B, 1)),
        both float32, computed in ``compute_dtype``.  With ``train`` the
        BatchNorms use batch statistics, and a third item lists each
        one's batch (mean, var) in ``batch_norms`` order; with a ``mesh``
        of several ranks those of the global batch (``_norm``)."""
        stats = [] if train else None
        x = boards.to(self.compute_dtype).permute(0, 3, 1, 2)
        h = F.relu(_norm(self.stem_bn, _conv(self.stem_conv, x), stats, mesh))
        for block in self.blocks:
            h = block(h, stats, mesh)
        p = F.relu(_norm(self.policy_bn, _conv(self.policy_conv, h), stats,
                         mesh))
        logits = _dense(self.policy_out, self._flatten_nhwc(p))
        v = F.relu(_norm(self.value_bn, _conv(self.value_conv, h), stats,
                         mesh))
        v = F.relu(_dense(self.value_hidden, self._flatten_nhwc(v)))
        value = torch.tanh(_dense(self.value_out, v))
        if train:
            return logits.float(), value.float(), stats
        return logits.float(), value.float()


def make_predict_fn(model: AZNet):
    """predict(boards (B, N, N, 17)) -> (softmax policy (B, N*N+1),
    values (B, 1)) in float32, in eval mode and without autograd.  The
    model computes in its ``compute_dtype``; its parameters stay float32."""
    model.eval()

    def predict(boards):
        with torch.inference_mode():
            logits, values = model(boards)
        return torch.softmax(logits, dim=-1), values

    return predict
