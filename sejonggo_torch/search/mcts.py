"""Batched MCTS with the reference's frontier-batched search (port of
sejonggo_tpu/search/mcts.py).

One round over B trees (reference simulate, self_play.py:28-120):
1. descend from the root along the top-1 PUCT chain to the frontier,
   the first node whose best child is unexpanded;
2. take the top-k PUCT actions at the frontier (ties -> lower action);
3. walk each through expanded children by top-1 PUCT to its unexpanded
   leaf edge;
4. step all B*k leaves with the next mover's legality in one call (the
   gostep kernel on the card) and evaluate them in one net call;
5. expand the leaves and back their values up to the root.

PUCT: score = Q + c_puct * P * sqrt(sum_b N_b) / (1 + N_a), Q = W/N (0
unvisited), illegal -> -inf.  Values are backed up in the root player's
perspective (the reference) unless ``negamax``.

This ports what the JAX package's TPU workarounds compute, not how: its
one-hot matmul gathers and compactions become index gathers, its
permutation-squaring descent becomes pointer doubling (capped at
ceil(log2 C) steps, which covers any chain of C nodes), and its closure
backup keeps its node-centric sums but builds each new leaf's ancestor
path by pointer doubling instead of squaring a (C, C) matrix.  No step
has a trip count that depends on the data, and no float sum depends on
the order of atomics.  Every function returns new tensors and leaves its
input Tree untouched.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from sejonggo_torch.goenv import engine
from sejonggo_torch.goenv.symmetry import (NUM_REFERENCE_SYMMETRIES,
                                           inverse_policy, transform_flat)
from sejonggo_torch.search.tree import Tree


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-tree row gather: x (B, C, ...), idx (B, G) -> (B, G, ...)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx.long()]


def _doublings(c: int) -> int:
    return max(1, math.ceil(math.log2(max(c, 2))))


def puct_scores_all(tree: Tree, c_puct: float) -> torch.Tensor:
    """(B, C, A) PUCT scores of every node."""
    cn = tree.child_N.to(torch.float32)
    total = torch.sqrt(cn.sum(-1, keepdim=True))
    total = torch.where(total == 0, 1.0, total)
    q = torch.where(cn > 0, tree.child_W / torch.clamp(cn, min=1.0), 0.0)
    u = c_puct * tree.node_P * total / (1.0 + cn)
    return torch.where(tree.node_legal, q + u, float("-inf"))


def collect_leaves(tree: Tree, k: int, c_puct: float):
    """Pick k leaf edges per tree: (leaf_p, leaf_a, active), each (B, k)."""
    scores = puct_scores_all(tree, c_puct)                  # (B, C, A)
    best = scores.argmax(-1).to(torch.int32)                 # first max
    b, c, _ = scores.shape
    iota = torch.arange(c, dtype=torch.int32, device=scores.device)
    nxt = torch.gather(tree.child_idx, 2, best.long()[..., None])[..., 0]
    g = torch.where(nxt < 0, iota[None], nxt)
    # fix[n] = end of n's best-chain: the first node whose best child is
    # unexpanded.  Children sit at larger slots than their parents, so a
    # chain has fewer than C hops and ceil(log2 C) doublings reach it.
    fix = g
    for _ in range(_doublings(c)):
        fix = torch.gather(fix, 1, fix.long())
    f = fix[:, 0]                                            # frontier (B,)
    bidx = torch.arange(b, device=scores.device)
    fscores = scores[bidx, f.long()]                         # (B, A)
    actions = torch.argsort(-fscores, dim=-1, stable=True)[:, :k]
    active = torch.gather(fscores, 1, actions) > float("-inf")
    actions = actions.to(torch.int32)
    ch = torch.gather(tree.child_idx[bidx, f.long()], 1, actions.long())
    tgt = torch.gather(fix, 1, ch.clamp(min=0).long())
    best_tgt = torch.gather(best, 1, tgt.long())
    leaf_p = torch.where(ch < 0, f[:, None], tgt)
    leaf_a = torch.where(ch < 0, actions, best_tgt)
    return leaf_p, leaf_a, active


def _ancestor_signs(parent: torch.Tensor, slots: torch.Tensor,
                    negamax: bool) -> torch.Tensor:
    """(B, k, C) float32: M[b, l, x] = s^t where node x is the t-th
    ancestor of slot ``slots[b, l]`` (t = 0 for the slot itself, up to
    the root), s = -1 in negamax and 1 otherwise; 0 for other nodes.

    The ancestor paths are built by pointer doubling: the path's first m
    entries, then the same entries moved up by parent^m, for m = 1, 2, 4,
    ... until m covers C (parents sit at lower slots, so a path has at
    most C entries).  Past the root the path stays at slot 0; those
    entries go to a dump column."""
    b, c = parent.shape
    k = slots.shape[1]
    up = parent.long()
    path = slots.long()[..., None]                            # (B, k, 1)
    while path.shape[-1] < c:
        moved = torch.gather(up, 1, path.reshape(b, -1)).view_as(path)
        path = torch.cat([path, moved], dim=-1)
        up = torch.gather(up, 1, up)
    path = path[..., :c]
    t = torch.arange(c, device=parent.device)
    past_root = torch.zeros_like(path, dtype=torch.bool)
    past_root[..., 1:] = path[..., :-1] == 0
    sign = (1 - 2 * (t % 2)) if negamax else torch.ones_like(t)
    sign = sign.to(torch.float32).expand(b, k, c)
    m = torch.zeros((b, k, c + 1), dtype=torch.float32, device=parent.device)
    m.scatter_(2, torch.where(past_root, c, path), sign)
    return m[..., :c]


def expand_backup(tree: Tree, leaf_p, leaf_a, leaf_stones, leaf_side,
                  active, policies, values, legal, negamax: bool,
                  slot_base: int | None = None) -> Tree:
    """Allocate the k new nodes per tree, set priors and legality, wire
    child pointers and back the values up to the root.

    slot_base: a batch-uniform first slot (run_search reserves
    [capacity - simulations, capacity) in every tree); None allocates at
    each tree's n_nodes."""
    b, k = leaf_p.shape
    dev = leaf_p.device
    bidx = torch.arange(b, device=dev)[:, None]
    ar = torch.arange(k, dtype=torch.int32, device=dev)[None]
    if slot_base is None:
        slots = tree.n_nodes[:, None] + ar
    else:
        slots = (slot_base + ar).expand(b, k)
    sl = slots.long()

    def put(x, v):
        x = x.clone()
        x[bidx, sl] = v
        return x

    node_stones = put(tree.node_stones, leaf_stones)
    node_side = put(tree.node_side, leaf_side)
    node_P = put(tree.node_P, policies)
    node_legal = put(tree.node_legal, legal & active[..., None])
    parent = put(tree.parent, torch.where(active, leaf_p, 0))
    parent_action = put(tree.parent_action, torch.where(active, leaf_a, -1))
    n_nodes = slots[:, -1] + 1
    child_idx = tree.child_idx.clone()
    old = child_idx[bidx, leaf_p.long(), leaf_a.long()]
    child_idx[bidx, leaf_p.long(), leaf_a.long()] = torch.where(active, slots, old)

    # value sign (reference self_play.py:100-102): the leaf value is
    # flipped into the root player's perspective by side to move
    v = values.reshape(b, k).to(torch.float32)
    if negamax:
        val = -v
    else:
        val = torch.where(leaf_side == tree.node_side[:, :1], v, -v)

    # the closure backup of the JAX package: every new leaf adds (1, its
    # value, sign-flipped per level in negamax) to the edge into each of
    # its ancestors, so node x's edge gains d_N[x] = sum_l |M[l, x]| and
    # d_V[x] = sum_l val_l M[l, x], with M[l, x] = (+-1)^t where x is the
    # leaf's t-th ancestor (0 elsewhere).  The sums over the leaf axis are
    # plain reductions, whose order is fixed for a shape on a device, and
    # each edge then takes one addend: no atomics, and no trip count that
    # depends on the depth of the tree.
    m = _ancestor_signs(parent, slots, negamax)               # (B, k, C)
    d_n = (active[..., None] & (m != 0)).sum(1, dtype=torch.int32)
    d_v = (torch.where(active, val, 0.0)[..., None] * m).sum(1)  # (B, C)
    has = child_idx >= 0
    ci = child_idx.clamp(min=0).long().view(b, -1)
    child_N = tree.child_N + torch.where(
        has, torch.gather(d_n, 1, ci).view_as(has), 0)
    child_W = tree.child_W + torch.where(
        has, torch.gather(d_v, 1, ci).view_as(has), 0.0)
    root_N = tree.root_N + active.sum(1, dtype=torch.int32)
    # the root's deposit is its depth-1 ancestor's: -d_V[0] in negamax
    root_W = tree.root_W + (-d_v[:, 0] if negamax else d_v[:, 0])
    return tree.replace(
        node_stones=node_stones, node_side=node_side, node_P=node_P,
        node_legal=node_legal, child_N=child_N, child_W=child_W,
        child_idx=child_idx, parent=parent, parent_action=parent_action,
        n_nodes=n_nodes, root_N=root_N, root_W=root_W)


def leaf_features(trees: Tree, leaf_p, leaf_stones, leaf_side, sym=None):
    """(B, k, N, N, 17) int8: the reference's 17-plane stack of each leaf,
    rebuilt from its ancestor chain of stone grids and, past the root,
    from the root's stored history planes.

    Plane pair j of a position holds (own, opponent) stones j positions
    ago in the leaf's mover colours s: along the chain that is
    (stones == s, stones == -s); past the root (m = the first chain step
    that is the root slot) the root's pair j - m applies, swapped iff m
    is odd.  ``sym``: a D4 id for the whole batch (int) or one per tree
    ((B,) tensor), applied to the source grids."""
    b, k = leaf_p.shape
    n = leaf_stones.shape[-1]
    nn = n * n
    dev = leaf_p.device
    bidx = torch.arange(b, device=dev)[:, None]

    idx = leaf_p.long()
    chain_idx = []
    for _ in range(7):
        chain_idx.append(idx)
        idx = trees.parent[bidx, idx].long()
    a = torch.stack(chain_idx, dim=2)                        # (B, k, 7)
    hit = a == 0
    chain = _rows(trees.node_stones.reshape(b, -1, nn),
                  a.reshape(b, k * 7)).reshape(b, k, 7, nn)

    m = torch.where(hit.any(2), 1 + hit.to(torch.int8).argmax(2), 8)[..., None]
    jr = torch.arange(1, 8, device=dev)[None, None]
    onchain = jr <= m                                        # (B, k, 7)
    q = jr - m
    sw = m % 2
    own_pi = (2 * q + sw).clamp(0, 15)
    opp_pi = (2 * q + 1 - sw).clamp(0, 15)
    pidx = torch.stack([own_pi, opp_pi], dim=-1).reshape(b, k * 14)
    root_t = trees.root_board.reshape(b, nn, 17).transpose(1, 2)  # (B,17,nn)
    rows = _rows(root_t, pidx).reshape(b, k, 7, 2, nn)
    leaf_flat = leaf_stones.reshape(b, k, nn)

    if sym is not None:
        chain = transform_flat(chain, sym, n)
        rows = transform_flat(rows, sym, n)
        leaf_flat = transform_flat(leaf_flat, sym, n)

    s = leaf_side.to(torch.int8)[:, :, None]                 # (B, k, 1)
    s4 = s[:, :, None]
    oc = onchain[..., None]
    own = torch.where(oc, chain == s4, rows[:, :, :, 0] == 1)
    opp = torch.where(oc, chain == -s4, rows[:, :, :, 1] == 1)
    planes = [leaf_flat == s, leaf_flat == -s]
    for j in range(7):
        planes += [own[:, :, j], opp[:, :, j]]
    feats = torch.stack(planes, dim=-1).to(torch.int8)       # (B, k, nn, 16)
    side_plane = s[..., None].expand(b, k, nn, 1).to(torch.int8)
    feats = torch.cat([feats, side_plane], dim=-1)
    return feats.reshape(b, k, n, n, 17)


def simulate_round(trees: Tree, predict_fn: Callable, *, batch_size: int,
                   c_puct: float = 1.0, negamax: bool = False,
                   sym=None, slot_base: int | None = None) -> Tree:
    """One search round over B trees: one env step + legality call and
    one net call for all B*k leaves.  ``sym``: None (no symmetry), an int
    D4 id for the whole batch, or a (B,) tensor of per-tree ids."""
    k = batch_size
    leaf_p, leaf_a, active = collect_leaves(trees, k, c_puct)
    b = leaf_p.shape[0]
    n = trees.node_stones.shape[-1]
    parent_stones = _rows(trees.node_stones, leaf_p)        # (B, k, N, N)
    parent_side = _rows(trees.node_side, leaf_p)            # (B, k)
    flat_stones, flat_illegal = engine.step_and_illegal_stones_batch(
        parent_stones.reshape(b * k, n, n), parent_side.reshape(-1),
        leaf_a.reshape(-1))
    leaf_side = -parent_side
    leaf_stones = flat_stones.reshape(b, k, n, n)
    legal = (~flat_illegal).reshape(b, k, -1)

    feats = leaf_features(trees, leaf_p, leaf_stones, leaf_side, sym=sym)
    policies, values = predict_fn(feats.reshape(b * k, n, n, 17))
    if sym is not None:
        policies = inverse_policy(
            policies, sym if isinstance(sym, int)
            else sym.to(policies.device).repeat_interleave(k))
    return expand_backup(trees, leaf_p, leaf_a, leaf_stones, leaf_side,
                         active, policies.reshape(b, k, -1),
                         values.reshape(b, k), legal, negamax,
                         slot_base=slot_base)


def draw_symmetry(batch: int | None, generator: torch.Generator | None,
                  device) -> int | torch.Tensor:
    """A D4 id for the whole batch (batch None) or one per tree, drawn
    from the reference's 7 symmetries (symmetry.py:127-132)."""
    if batch is None:
        return int(torch.randint(0, NUM_REFERENCE_SYMMETRIES, (1,),
                                 generator=generator))
    return torch.randint(0, NUM_REFERENCE_SYMMETRIES, (batch,),
                         generator=generator).to(device)


def run_search(trees: Tree, predict_fn: Callable, *, simulations: int,
               batch_size: int, c_puct: float = 1.0, negamax: bool = False,
               use_symmetry: bool = False, per_game_symmetry: bool = False,
               syms=None, generator: torch.Generator | None = None) -> Tree:
    """simulations // batch_size rounds (reference mcts_decision
    self_play.py:128-132).  Round r expands into the static slots
    capacity - simulations + r*k when that region exists.

    With ``use_symmetry`` each round draws one D4 id (one per tree when
    ``per_game_symmetry``) from ``generator`` on the CPU, unless ``syms``
    gives the ids, one entry per round."""
    rounds = simulations // batch_size
    capacity = trees.node_stones.shape[1]
    base0 = capacity - simulations
    b = trees.node_side.shape[0]
    for r in range(rounds):
        sym = None
        if use_symmetry:
            sym = syms[r] if syms is not None else draw_symmetry(
                b if per_game_symmetry else None, generator,
                trees.node_side.device)
        trees = simulate_round(
            trees, predict_fn, batch_size=batch_size, c_puct=c_puct,
            negamax=negamax, sym=sym,
            slot_base=base0 + r * batch_size if base0 >= 1 else None)
    return trees


def decide_batch(trees: Tree, greedy: torch.Tensor,
                 generator: torch.Generator | None = None, *,
                 gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """(B,) root moves.  Greedy rows: the lexicographic max of (count,
    mean value, action) over legal actions (reference self_play.py:151).
    Other rows sample proportionally to visit counts: the Gumbel-max
    argmax(log N + g) that ``jax.random.categorical`` computes, with the
    (B, A) float32 draws ``gumbel`` or, without them, draws made on the
    CPU from ``generator``.  Rows without visits take the greedy move."""
    counts = trees.child_N[:, 0]
    b, a = counts.shape
    dev = counts.device
    cf = counts.to(torch.float32)
    logits = torch.where(counts > 0, torch.log(cf), float("-inf"))
    if gumbel is None:
        u = torch.rand((b, a), generator=generator)
        gumbel = -torch.log(-torch.log(u.clamp(min=1e-20, max=1 - 1e-7)))
    gumbel = gumbel.to(dev, torch.float32)
    sampled = (logits + gumbel).argmax(-1).to(torch.int32)

    c = torch.where(trees.node_legal[:, 0], counts, -1)
    maxc = c.max(-1, keepdim=True).values
    m1 = c == maxc
    mean = torch.where(counts > 0, trees.child_W[:, 0] / torch.clamp(cf, min=1.0), 0.0)
    mv = torch.where(m1, mean, float("-inf"))
    m2 = m1 & (mv == mv.max(-1, keepdim=True).values)
    ar = torch.arange(a, dtype=torch.int32, device=dev)
    greedy_a = torch.where(m2, ar, -1).max(-1).values
    sampled = torch.where(counts.max(-1).values > 0, sampled, greedy_a)
    return torch.where(greedy.to(dev), greedy_a, sampled)


def policy_target_batch(trees: Tree, mode: str = "prior") -> torch.Tensor:
    """Training policy target at the root: the (noisy) priors as the
    reference records them ('prior'), or normalised visits ('visits')."""
    legal = trees.node_legal[:, 0]
    if mode == "prior":
        return torch.where(legal, trees.node_P[:, 0], 0.0)
    counts = torch.where(legal, trees.child_N[:, 0], 0).to(torch.float32)
    total = torch.clamp(counts.sum(-1, keepdim=True), min=1.0)
    return counts / total


def _keep_subtree(parent: torch.Tensor, nr: torch.Tensor) -> torch.Tensor:
    """(B, C) mask of nr's subtree (nr and its descendants) by pointer
    doubling: after t steps keep covers descendants within 2^t levels."""
    c = parent.shape[1]
    iota = torch.arange(c, device=parent.device)
    keep = iota[None] == nr[:, None]
    anc = parent.long()
    for _ in range(_doublings(c)):
        keep = keep | torch.gather(keep, 1, anc)
        anc = torch.gather(anc, 1, anc)
    return keep


def advance_root_batch(trees: Tree, actions: torch.Tensor,
                       new_root_boards: torch.Tensor, reserve: int = 0):
    """Re-root every tree at its child ``actions`` (reference tree reuse,
    self_play.py:224-238) and compact the survivors to the front.

    ``new_root_boards``: (B, N, N, 17) boards after the move.  The
    survivors are truncated to ``capacity - reserve`` slots in index
    order (index order is topological); edges into dropped nodes revert
    to unexpanded but keep their statistics.  Returns (trees, valid);
    valid is False where the child was never expanded."""
    b, c, a_dim = trees.child_idx.shape
    dev = actions.device
    bidx = torch.arange(b, device=dev)
    budget = c - reserve
    act = actions.long()
    new_root = trees.child_idx[bidx, 0, act]
    valid = new_root >= 0 if budget >= 1 else torch.zeros_like(new_root, dtype=torch.bool)
    nr = new_root.clamp(min=0).long()

    iota = torch.arange(c, device=dev)
    keep = _keep_subtree(trees.parent, nr)
    rank = keep.to(torch.int64).cumsum(1) - 1
    keep = keep & (rank < max(budget, 1))
    n_new = keep.sum(1)
    live = iota[None] < n_new[:, None]                       # (B, C)

    # old slot of each new slot (dump column c for dropped nodes)
    old_of_new = torch.zeros((b, c + 1), dtype=torch.int64, device=dev)
    old_of_new.scatter_(1, torch.where(keep, rank, c), iota[None].expand(b, c))
    old_of_new = old_of_new[:, :c]
    bi = bidx[:, None]

    def take(x, fill):
        g = x[bi, old_of_new]
        mask = live.view(b, c, *([1] * (g.dim() - 2)))
        return torch.where(mask, g, torch.as_tensor(fill, dtype=g.dtype, device=dev))

    parent_old = trees.parent[bi, old_of_new].long()
    par = torch.where(live, rank[bi, parent_old], 0)
    par[:, 0] = 0
    pa = take(trees.parent_action, -1)
    pa[:, 0] = -1

    # child_idx from (parent, action) of each live non-root node; edges
    # whose child was truncated stay -1.  Slots of inactive leaves carry
    # the action -1 (they survive only in an invalid re-root at the old
    # root); as in JAX's index normalisation it lands on the last edge,
    # the pass.  Where several slots share an edge the highest slot wins,
    # as in JAX's in-order scatter on the CPU; amax makes that rule
    # deterministic on every device
    ok = live & (iota[None] > 0)
    edge = torch.where(pa < 0, pa + a_dim, pa).long()
    flat = torch.where(ok, par * a_dim + edge, c * a_dim)
    ci = torch.full((b, c * a_dim + 1), -1, dtype=torch.int32, device=dev)
    ci.scatter_reduce_(1, flat, iota[None].expand(b, c).to(torch.int32),
                       "amax")
    ci = ci[:, :c * a_dim].reshape(b, c, a_dim)

    out = Tree(
        root_board=new_root_boards.to(torch.int8).clone(),
        node_stones=take(trees.node_stones, 0),
        node_side=take(trees.node_side, 0),
        node_P=take(trees.node_P, 0.0),
        node_legal=take(trees.node_legal, False),
        child_N=take(trees.child_N, 0),
        child_W=take(trees.child_W, 0.0),
        child_idx=ci,
        parent=par.to(torch.int32),
        parent_action=pa,
        n_nodes=torch.clamp(n_new, min=1).to(torch.int32),
        root_N=trees.child_N[bidx, 0, act],
        root_W=trees.child_W[bidx, 0, act],
    )
    return out, valid
