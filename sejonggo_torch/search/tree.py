"""Array-backed MCTS tree state (port of sejonggo_tpu/search/tree.py).

A batch of B trees is a dataclass of tensors with a leading batch axis.
Statistics live on edges (parent node, action): ``child_N``/``child_W``
are the per-child count and value sum, ``child_idx`` points to the
child's node slot once expanded (-1 before).  The root is slot 0 and
keeps its own (count, value) in ``root_N``/``root_W``.  Nodes store only
their signed stone grid and side to move; the full 17-plane board lives
at the root (``root_board``) and leaf features are rebuilt from the
ancestor chain (search.mcts.leaf_features).

The search functions never write into a Tree's tensors in place: each
returns a new Tree, so a caller may keep an earlier one (the move step
keeps the pre-search tree of finished games).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sejonggo_torch.goenv import engine


@dataclasses.dataclass
class Tree:
    """B trees.  C = node capacity, A = actions (N*N+1)."""

    root_board: torch.Tensor     # (B, N, N, 17) int8
    node_stones: torch.Tensor    # (B, C, N, N) int8
    node_side: torch.Tensor      # (B, C) int8
    node_P: torch.Tensor         # (B, C, A) f32 priors
    node_legal: torch.Tensor     # (B, C, A) bool
    child_N: torch.Tensor        # (B, C, A) i32
    child_W: torch.Tensor        # (B, C, A) f32
    child_idx: torch.Tensor      # (B, C, A) i32, -1 = unexpanded
    parent: torch.Tensor         # (B, C) i32 (root: 0)
    parent_action: torch.Tensor  # (B, C) i32 (root: -1)
    n_nodes: torch.Tensor        # (B,) i32 allocation high-water mark
    root_N: torch.Tensor         # (B,) i32
    root_W: torch.Tensor         # (B,) f32

    def replace(self, **kw) -> "Tree":
        return dataclasses.replace(self, **kw)

    def fields(self):
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


def tree_capacity(simulations: int, batch_size: int) -> int:
    """Node slots: one per simulation plus a reuse budget of the same
    order for the subtree carried across moves."""
    return 2 * simulations + batch_size + 2


def tree_where(mask: torch.Tensor, a: Tree, b: Tree) -> Tree:
    """Per-tree select: tree i from ``a`` where mask[i], else from ``b``."""
    def sel(x, y):
        return torch.where(mask.view((-1,) + (1,) * (x.dim() - 1)), x, y)

    return Tree(**{k: sel(v, getattr(b, k)) for k, v in a.fields().items()})


def sample_dirichlet(alpha: float, batch: int, size: int,
                     generator: torch.Generator | None = None,
                     device=None) -> torch.Tensor:
    """(batch, size) Dirichlet(alpha) draws from ``generator``.

    Gamma(alpha) by Marsaglia-Tsang on alpha + 1 with the U^(1/alpha)
    boost, kept in log space and normalised by a softmax so that tiny
    alphas (0.03) do not underflow.  The rejection loop accepts about 98%
    of draws per pass and is capped at 64 passes."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    shape = (batch, size)
    log_g = torch.zeros(shape, dtype=torch.float32, device=device)
    todo = torch.ones(shape, dtype=torch.bool, device=device)
    for _ in range(64):
        x = torch.randn(shape, generator=generator, device=device)
        u = torch.rand(shape, generator=generator, device=device)
        v = (1.0 + c * x) ** 3
        vpos = v.clamp(min=1e-30)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(vpos))
        take = todo & ok
        log_g = torch.where(take, torch.log(d * vpos), log_g)
        todo = todo & ~ok
        if not bool(todo.any()):
            break
    else:
        raise RuntimeError("Dirichlet sampler did not accept within 64 passes")
    if alpha < 1.0:
        u = torch.rand(shape, generator=generator, device=device)
        log_g = log_g + torch.log(u.clamp(min=1e-38)) / alpha
    return torch.softmax(log_g, dim=-1)


def _flush(v: torch.Tensor) -> torch.Tensor:
    """float32 subnormals to zero, as XLA's CPU code flushes them."""
    return torch.where(v.abs() < torch.finfo(torch.float32).tiny, 0.0, v)


def _round_sum_f32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + y rounded once to float32, for float64 tensors that are exact.

    TwoSum gives their float64 sum s and its rounding error e exactly;
    rounding s to float32 is correct except where s lies exactly halfway
    between two float32 values and e breaks the tie."""
    s = x + y
    bp = s - x
    e = (x - (s - bp)) + (y - bp)
    r = s.to(torch.float32)
    above = r.to(torch.float64) > s
    lo = torch.where(above, torch.nextafter(r, torch.full_like(r, -torch.inf)), r)
    hi = torch.where(above, r, torch.nextafter(r, torch.full_like(r, torch.inf)))
    mid = (s - lo.to(torch.float64)) == (hi.to(torch.float64) - s)
    return torch.where(mid & (e > 0), hi, torch.where(mid & (e < 0), lo, r))


def _f64(x):
    """A float32 tensor in float64, or a Python number as the float32
    value nearest it (a Python float holds it exactly)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).to(torch.float64)
    return float(np.float32(x))


def fma32(a, b, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once: the fused multiply-add that XLA's
    CPU backend contracts a float32 product and sum into.  The product of
    two float32 values is exact in float64.  ``a`` and ``b`` may be
    Python numbers (taken as float32 values)."""
    x = _f64(a) * _f64(b)
    if not isinstance(x, torch.Tensor):
        x = torch.full_like(c, x, dtype=torch.float64)
    return _round_sum_f32(x, c.to(torch.float64))


def mix_noise(p: torch.Tensor, noise: torch.Tensor,
              epsilon: float) -> torch.Tensor:
    """float32 (1 - epsilon) * p + epsilon * noise, rounded once.

    XLA's CPU backend contracts the JAX package's mix into
    fma(1 - epsilon, p, epsilon * noise): the float32 product
    epsilon * noise plus the exact product (1 - epsilon) * p, rounded
    once.  XLA's CPU code also flushes float32 subnormals to zero, in its
    inputs and its results; so does this."""
    keep = float(torch.tensor(1.0 - epsilon, dtype=torch.float32))
    return _flush(fma32(keep, _flush(p), _flush(epsilon * _flush(noise))))


def empty_tree_batch(batch: int, capacity: int, size: int, device) -> Tree:
    a = size * size + 1
    z = dict(device=device)
    return Tree(
        root_board=torch.zeros((batch, size, size, engine.NUM_PLANES),
                               dtype=torch.int8, **z),
        node_stones=torch.zeros((batch, capacity, size, size),
                                dtype=torch.int8, **z),
        node_side=torch.zeros((batch, capacity), dtype=torch.int8, **z),
        node_P=torch.zeros((batch, capacity, a), dtype=torch.float32, **z),
        node_legal=torch.zeros((batch, capacity, a), dtype=torch.bool, **z),
        child_N=torch.zeros((batch, capacity, a), dtype=torch.int32, **z),
        child_W=torch.zeros((batch, capacity, a), dtype=torch.float32, **z),
        child_idx=torch.full((batch, capacity, a), -1, dtype=torch.int32, **z),
        parent=torch.zeros((batch, capacity), dtype=torch.int32, **z),
        parent_action=torch.full((batch, capacity), -1, dtype=torch.int32, **z),
        n_nodes=torch.ones((batch,), dtype=torch.int32, **z),
        root_N=torch.zeros((batch,), dtype=torch.int32, **z),
        root_W=torch.zeros((batch,), dtype=torch.float32, **z),
    )


def new_tree_batch(policies: torch.Tensor, boards: torch.Tensor,
                   capacity: int, noise: torch.Tensor | None = None,
                   epsilon: float = 0.25) -> Tree:
    """B fresh trees rooted at ``boards`` (B, N, N, 17) with root priors
    ``policies`` (B, A), unrenormalised after masking (reference
    play.py:376-421).  ``noise`` (B, A), when given, mixes in as
    (1 - epsilon) * p + epsilon * noise (self-play root noise; draw it
    with ``sample_dirichlet``)."""
    b, size = boards.shape[0], boards.shape[-3]
    tree = empty_tree_batch(b, capacity, size, boards.device)
    legal = ~engine.illegal_moves_mask_batch(boards)
    p = policies.to(torch.float32)
    if noise is not None:
        p = mix_noise(p, noise.to(p.device, torch.float32), epsilon)
    tree.root_board = boards.to(torch.int8).clone()
    tree.node_stones[:, 0] = engine.signed_stones(boards)
    tree.node_side[:, 0] = boards[:, 0, 0, 16].to(torch.int8)
    tree.node_P[:, 0] = p
    tree.node_legal[:, 0] = legal
    return tree
