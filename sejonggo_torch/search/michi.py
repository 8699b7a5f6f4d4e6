"""Batched michi-style RAVE MCTS, the model-free engine (port of
sejonggo_tpu/search/michi.py).

Reference counterpart: mcts1/ (tree_search.py, tree_node.py,
go_heuristics.py) — the UCB1-RAVE tree policy (rave_urgency
tree_node.py:91-98), expansion at EXPAND_VISITS with heuristic priors
(TreeNode.expand tree_node.py:22-89), heuristic Monte-Carlo playouts
(mcplayout tree_search.py:177-220) and the early-stop thresholds
(tree_search.py:127-130).  B trees advance in lockstep.

Tree layout: statistics live on edges (parent node, action) —
``edge_v/edge_w`` are the reference child node's v/w, ``edge_pv/
edge_pw`` its priors, ``edge_av/edge_aw`` its AMAF stats.  Node slots
(with stored boards) are allocated when an edge reaches
``expand_visits``.

One round (``michi_search_batch``): k descents in order (each visit
increment is the next descent's virtual loss), one batched env step of
the k*B stop edges (the flood kernel), the expansion candidates' priors
in one batch, the expansions attached in descent order, one batched
playout of the k*B leaves (the gostep kernel every step), then the k
updates in order.  Games are batched, never the k descents.

Random draws are arguments: each round takes ``draws(round)`` — the
descents' tie-break jitter, the playout's five gate uniforms and its
Gumbel draws per step — or draws them from ``generator`` on the search's
device.  The tests hand in JAX's own draws.  Loops whose trip count
depends on the data (a descent, a playout) run over all games with the
finished ones frozen, and read the host once every few iterations to
end when all are finished; their draws are indexed by iteration, so
ending early changes no result.

Deviations of the JAX package from the reference, kept here:
- the simulation that triggers an expansion starts its playout at the
  freshly expanded node;
- playout suggestions are class-gated and self-atari rejection filters
  the class;
- ties among equal urgencies are broken by per-descent random jitter.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from sejonggo_torch.config import MichiConfig
from sejonggo_torch.goenv import engine
from sejonggo_torch.goenv.engine import NUM_PLANES
from sejonggo_torch.search import heuristics as H
from sejonggo_torch.search.pattern_lut import lut_bonus_from
from sejonggo_torch.search.tree import fma32

_DESCENT_CHECK_EVERY = 4   # descent levels between host reads
_PLAYOUT_CHECK_EVERY = 8   # playout steps between host reads


@dataclasses.dataclass
class MichiTree:
    """B RAVE trees.  C = node capacity, A = N*N+1 (last action = pass)."""

    node_board: torch.Tensor     # (B, C, N, N, 17) int8
    node_playable: torch.Tensor  # (B, C, A) bool — legal non-eye moves (+pass)
    edge_pv: torch.Tensor        # (B, C, A) f32 — prior visits
    edge_pw: torch.Tensor        # (B, C, A) f32 — prior wins
    edge_v: torch.Tensor         # (B, C, A) i32 — visits
    edge_w: torch.Tensor         # (B, C, A) f32 — wins (for just-played)
    edge_av: torch.Tensor        # (B, C, A) i32 — AMAF visits
    edge_aw: torch.Tensor        # (B, C, A) f32 — AMAF wins
    child_idx: torch.Tensor      # (B, C, A) i32 — child slot or -1
    n_nodes: torch.Tensor        # (B,) i32
    root_v: torch.Tensor         # (B,) i32
    root_w: torch.Tensor         # (B,) f32
    # host-side bound on the deepest node's depth (root 0): a descent
    # walks at most height + 1 levels, so it needs no host read
    height: int = 0

    def fields(self):
        """The tensor fields, by name (``height`` is not one)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name != "height"}

    def clone(self) -> "MichiTree":
        return MichiTree(**{k: v.clone() for k, v in self.fields().items()},
                         height=self.height)


def _count(stats: Optional[dict], key: str, n: int = 1) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + n


# ---------------------------------------------------------------------------
# expansion: playable mask + heuristic priors (TreeNode.expand parity)


def playable_mask(boards: torch.Tensor,
                  analysis: Optional[H.GroupAnalysis] = None) -> torch.Tensor:
    """(B, A) bool: legal moves that don't fill an own true eye; pass is
    playable only when nothing else is (reference expand() falls back to
    a lone pass child, tree_node.py:87-89)."""
    b, n = boards.shape[0], boards.shape[-3]
    own, opp = boards[..., 0] == 1, boards[..., 1] == 1
    a = analysis if analysis is not None else H.closure_analysis(own, opp)
    legal = ~H.illegal_from(a, H.board_ko_point(boards))
    pts = legal[:, :n * n] & ~H.own_true_eye_from(own, opp).reshape(b, -1)
    return torch.cat([pts, ~pts.any(-1, keepdim=True)], 1)


def michi_priors(boards: torch.Tensor, last_actions: torch.Tensor,
                 cfg: MichiConfig, pattern_lut: Optional[torch.Tensor] = None,
                 *, analysis: Optional[H.GroupAnalysis] = None,
                 stats: Optional[dict] = None):
    """(pv, pw): (B, A) f32 heuristic priors, reference TreeNode.expand
    tree_node.py:22-89 vectorized over all moves.

    last_actions: (B,) flat index of the move that created each position,
    or -1/pass for "no locality prior".  pattern_lut: optional (4^8,) f32
    small-radius pattern table (search/pattern_lut.py), added as
    prior_largepattern * lut at every expansion (tree_node.py:81-86)."""
    b, n = boards.shape[0], boards.shape[-3]
    nn = n * n
    dev = boards.device
    own, opp = boards[..., 0] == 1, boards[..., 1] == 1
    a = analysis if analysis is not None else H.closure_analysis(own, opp)
    sa_grid = H.self_atari_from(a)
    pv = torch.full((b, nn), float(cfg.prior_even), dtype=torch.float32,
                    device=dev)
    pw = torch.full((b, nn), cfg.prior_even / 2.0, dtype=torch.float32,
                    device=dev)

    def bump(pv, pw, mask, dv, dw):
        m = mask.reshape(b, nn).to(torch.float32)
        return pv + m * dv, pw + m * dw

    # capture / escape suggestions, sized by the analyzed group
    cap, many = H.capture_moves_from(a, self_atari=sa_grid)
    if cfg.use_ladders:
        lcap, lmany = H.ladder_capture_moves(boards, analysis=a, stats=stats)
        cap, many = cap | lcap, many | lmany
    pv, pw = bump(pv, pw, cap & ~many, cfg.prior_capture_one,
                  cfg.prior_capture_one)
    pv, pw = bump(pv, pw, cap & many, cfg.prior_capture_many,
                  cfg.prior_capture_many)

    # 3x3 patterns
    pv, pw = bump(pv, pw, H.pat3_mask_from(own, opp), cfg.prior_pat3,
                  cfg.prior_pat3)

    # CFG locality (d = 1..3), only when a last move exists
    la = last_actions.to(torch.int32)
    has_last = ((la >= 0) & (la < nn))[:, None, None]
    cfgd = H.cfg_distances(boards, torch.where(has_last[:, 0, 0], la, 0),
                           cap=4, analysis=a)
    for d, w in enumerate(cfg.prior_cfg, start=1):
        pv, pw = bump(pv, pw, (cfgd == d) & has_last, w, w)

    # line height on empty areas: 1st/2nd line negative, 3rd positive
    height = H.line_height_grid(n, dev)
    ea = H.empty_area_mask(boards)
    pv, pw = bump(pv, pw, ea & (height <= 1), cfg.prior_empty_area, 0.0)
    pv, pw = bump(pv, pw, ea & (height == 2), cfg.prior_empty_area,
                  cfg.prior_empty_area)

    # self-atari: negative prior
    pv, pw = bump(pv, pw, sa_grid, cfg.prior_selfatari, 0.0)

    if pattern_lut is not None:
        bonus = (lut_bonus_from(own, opp, pattern_lut).reshape(b, nn)
                 * cfg.prior_largepattern)
        pv, pw = pv + bonus, pw + bonus

    base = torch.full((b, 1), float(cfg.prior_even), dtype=torch.float32,
                      device=dev)
    return torch.cat([pv, base], 1), torch.cat([pw, base / 2.0], 1)


def _empty_tree(batch: int, capacity: int, size: int, device) -> MichiTree:
    a = size * size + 1

    def z(dtype, *shape):
        return torch.zeros((batch,) + shape, dtype=dtype, device=device)

    return MichiTree(
        node_board=z(torch.int8, capacity, size, size, NUM_PLANES),
        node_playable=z(torch.bool, capacity, a),
        edge_pv=z(torch.float32, capacity, a),
        edge_pw=z(torch.float32, capacity, a),
        edge_v=z(torch.int32, capacity, a),
        edge_w=z(torch.float32, capacity, a),
        edge_av=z(torch.int32, capacity, a),
        edge_aw=z(torch.float32, capacity, a),
        child_idx=torch.full((batch, capacity, a), -1, dtype=torch.int32,
                             device=device),
        n_nodes=torch.ones((batch,), dtype=torch.int32, device=device),
        root_v=z(torch.int32),
        root_w=z(torch.float32),
    )


@torch.inference_mode()
def new_michi_tree_batch(boards: torch.Tensor, cfg: MichiConfig,
                         last_actions: Optional[torch.Tensor] = None,
                         pattern_lut: Optional[torch.Tensor] = None,
                         root_bonus: Optional[torch.Tensor] = None,
                         stats: Optional[dict] = None) -> MichiTree:
    """Fresh trees rooted at ``boards`` (B, N, N, 17) with the roots
    pre-expanded (tree_search.py:67-68).  last_actions: (B,) move that
    created each position (the CFG locality prior, the reference's
    largest prior weights); -1 = none.  root_bonus: optional (B, A)
    large-pattern prior (patterns.py) added to pv and pw."""
    b, size = boards.shape[0], boards.shape[-3]
    dev = boards.device
    if last_actions is None:
        last_actions = torch.full((b,), -1, dtype=torch.int32, device=dev)
    boards = boards.to(torch.int8)
    t = _empty_tree(b, cfg.node_capacity(), size, dev)
    a = H.closure_analysis(boards[..., 0] == 1, boards[..., 1] == 1)
    pv, pw = michi_priors(boards, last_actions.to(dev), cfg, pattern_lut,
                          analysis=a, stats=stats)
    if root_bonus is not None:
        bonus = torch.as_tensor(root_bonus, dtype=torch.float32).to(dev)
        pv, pw = pv + bonus, pw + bonus
    t.node_board[:, 0] = boards
    t.node_playable[:, 0] = playable_mask(boards, a)
    t.edge_pv[:, 0] = pv
    t.edge_pw[:, 0] = pw
    return t


# ---------------------------------------------------------------------------
# descent


def _urgency(v_, pv, w, pw, av_, aw, playable, rave_equiv: float):
    """Elementwise RAVE urgency of edge statistics (any shape).

    Rounded as XLA's CPU code computes the JAX package's expression: the
    division by rave_equiv becomes a product by its float32 reciprocal,
    contracted with the sum before it, and the RAVE mix is one fused
    multiply-add."""
    v = torch.clamp(v_.to(torch.float32) + pv, min=1e-9)
    expectation = (w + pw) / v
    av = av_.to(torch.float32)
    rave = aw / torch.clamp(av, min=1.0)
    recip = np.float32(1.0) / np.float32(rave_equiv)
    beta = av / fma32(v * av, recip, av + v)
    mixed = torch.where(av > 0, fma32(1.0 - beta, expectation, beta * rave),
                        expectation)
    return torch.where(playable, mixed, float("-inf"))


def rave_urgency(tree: MichiTree, node: torch.Tensor,
                 rave_equiv: float) -> torch.Tensor:
    """(B, A) edge urgencies of each tree's ``node`` (reference
    rave_urgency tree_node.py:91-98)."""
    bidx = torch.arange(node.shape[0], device=node.device)
    nd = node.long()
    return _urgency(tree.edge_v[bidx, nd], tree.edge_pv[bidx, nd],
                    tree.edge_w[bidx, nd], tree.edge_pw[bidx, nd],
                    tree.edge_av[bidx, nd], tree.edge_aw[bidx, nd],
                    tree.node_playable[bidx, nd], rave_equiv)


def _descend(tree: MichiTree, active: torch.Tensor, cfg: MichiConfig,
             jitter: Callable[[int], torch.Tensor]):
    """One simulation's walk in every tree, in place on ``tree``: stats
    only (board steps, priors and the playout run batched per round).
    ``jitter(level)`` gives the (B, A) tie-break draws of a level.

    Returns (stop_parent, stop_act, stop_child, path_n, path_a, depth,
    amaf), each with a leading B axis: the stop edge is (stop_parent,
    stop_act); stop_child >= 0 when the walk ended at an existing node
    (terminal/depth stop), -1 at an unexpanded edge.  The JAX walk is a
    while loop; this one runs at most tree.height + 1 levels (capped at
    max_depth), past which no walk can go, with finished walks frozen,
    and ends once every walk has stopped (read every few levels)."""
    b, _, a_dim = tree.node_playable.shape
    size = tree.node_board.shape[-2]
    max_depth = cfg.max_depth(size)
    dev = active.device
    bidx = torch.arange(b, device=dev)
    inc = active.to(torch.int32)
    i32 = dict(dtype=torch.int32, device=dev)
    path_n = torch.zeros((b, max_depth), **i32)
    path_a = torch.full((b, max_depth), -1, **i32)
    amaf = torch.zeros((b, a_dim), dtype=torch.int8, device=dev)
    node = torch.zeros((b,), **i32)
    depth = torch.zeros((b,), **i32)
    passes = torch.zeros((b,), **i32)
    stop = torch.zeros((b,), dtype=torch.bool, device=dev)
    stop_parent = torch.zeros((b,), **i32)
    stop_act = torch.full((b,), a_dim - 1, **i32)
    stop_child = torch.full((b,), -1, **i32)
    # every node's urgencies at once: a walk visits a node once, so no
    # visit of this walk changes a row before the walk reads it
    urg_all = _urgency(tree.edge_v, tree.edge_pv, tree.edge_w, tree.edge_pw,
                       tree.edge_av, tree.edge_aw, tree.node_playable,
                       cfg.rave_equiv)
    for lvl in range(min(max_depth, tree.height + 1)):
        if lvl and lvl % _DESCENT_CHECK_EVERY == 0 and bool(stop.all()):
            break
        live = ~stop
        nd = node.long()
        act = (urg_all[bidx, nd] + jitter(lvl)).argmax(-1).to(torch.int32)
        ac = act.long()
        # a live walk is at depth == lvl
        path_n[:, lvl] = torch.where(live, node, path_n[:, lvl])
        path_a[:, lvl] = torch.where(live, act, path_a[:, lvl])
        # the visit doubles as the virtual loss of the round's later
        # descents (reference tree_descend comment, tree_search.py:35)
        tree.edge_v[bidx, nd, ac] += inc * live
        mover = tree.node_board[bidx, nd, 0, 0, 16]
        cur = amaf[bidx, ac]
        is_pt = act < a_dim - 1
        amaf[bidx, ac] = torch.where(live & is_pt & (cur == 0), mover, cur)
        new_passes = torch.where(is_pt, 0, passes + 1)
        child = tree.child_idx[bidx, nd, ac]
        has_child = child >= 0
        stop_now = live & (~has_child | (new_passes >= 2)
                           | (depth + 1 >= max_depth))
        stop_parent = torch.where(stop_now, node, stop_parent)
        stop_act = torch.where(stop_now, act, stop_act)
        stop_child = torch.where(stop_now, torch.where(has_child, child, -1),
                                 stop_child)
        node = torch.where(live & has_child, child, node)
        depth = torch.where(live, depth + 1, depth)
        passes = torch.where(live, new_passes, passes)
        stop = stop | stop_now
    tree.root_v += inc
    return stop_parent, stop_act, stop_child, path_n, path_a, depth, amaf


def _expand(tree: MichiTree, parent, act, stop_child, pv, pw, playable,
            stepped, active, expand_visits: int) -> torch.Tensor:
    """Attach one descent's expansion candidate to each game's tree, in
    place (the edge must still be unexpanded — two descents of a round
    can stop at the same edge).  Returns the playout's AMAF target per
    game: the existing stop node, the fresh slot, or -1."""
    b, c, _ = tree.node_playable.shape
    bidx = torch.arange(b, device=active.device)
    p, a = parent.long(), act.long()
    child_now = tree.child_idx[bidx, p, a]
    do = (active & (stop_child < 0) & (child_now < 0)
          & (tree.edge_v[bidx, p, a] >= expand_visits) & (tree.n_nodes < c))
    slot = tree.n_nodes.clamp(max=c - 1).long()

    def put(x, v):
        keep = x[bidx, slot]
        x[bidx, slot] = torch.where(do.view((b,) + (1,) * (v.dim() - 1)),
                                    v, keep)

    put(tree.node_board, stepped)
    put(tree.node_playable, playable)
    put(tree.edge_pv, pv)
    put(tree.edge_pw, pw)
    tree.child_idx[bidx, p, a] = torch.where(do, tree.n_nodes, child_now)
    leaf = torch.where(do, tree.n_nodes, torch.where(
        stop_child >= 0, stop_child, torch.where(child_now >= 0, child_now, -1)))
    tree.n_nodes += do.to(torch.int32)
    return leaf


# ---------------------------------------------------------------------------
# heuristic playout (mcplayout parity)


def _locality(last: torch.Tensor, last2: torch.Tensor, n: int) -> torch.Tensor:
    """(B, nn) bool: the last two moves (-1 = none; a pass marks nothing)
    and their 8-neighborhoods."""
    iota = torch.arange(n * n, device=last.device)
    pts = (iota[None, None] == torch.stack([last, last2], 1)[..., None]).any(1)
    pts = pts.reshape(-1, n, n)
    return (pts | H.neighbors8(pts, False).any(1)).reshape(-1, n * n)


def _playout_choose(stones, side, illegal, last, last2, cfg: MichiConfig,
                    gates: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """Batched move choice for one playout step: local capture
    suggestions (prob_capture), local pat3 (prob_pat3), then random
    non-eye-filling moves, with probabilistic self-atari rejection
    (tree_search.py:177-210).  gates: (B, 5) uniforms for the five
    Bernoulli gates (JAX's bernoulli(key, p) is uniform(key) < p); gumbel:
    (B, nn) for the categorical move (argmax(logits + gumbel))."""
    b, n = stones.shape[0], stones.shape[-1]
    nn = n * n
    own = stones == side[:, None, None]
    opp = stones == -side[:, None, None]
    a = H.closure_analysis(own, opp)
    sa_grid = H.self_atari_from(a)
    sam = sa_grid.reshape(b, nn)
    cap_g, _ = H.capture_moves_from(a, self_atari=sa_grid, with_many=False)
    playable = ~illegal[:, :nn] & ~H.own_true_eye_from(own, opp).reshape(b, nn)
    loc = _locality(last, last2, n) & playable
    cap = cap_g.reshape(b, nn) & loc
    p3 = H.pat3_mask_from(own, opp).reshape(b, nn) & loc

    # the five gates against their float32 probabilities, as JAX's
    # bernoulli compares
    probs = H._device_table(
        ("gates", cfg.prob_ssareject, cfg.prob_capture, cfg.prob_pat3,
         cfg.prob_rsareject), lambda: np.asarray(
            [cfg.prob_ssareject, cfg.prob_capture, cfg.prob_ssareject,
             cfg.prob_pat3, cfg.prob_rsareject], np.float32), gates.device)
    g = gates < probs
    cap = torch.where(g[:, 0:1], cap & ~sam, cap) & g[:, 1:2]
    p3 = torch.where(g[:, 2:3], p3 & ~sam, p3) & g[:, 3:4]
    rnd_nosa = playable & ~sam
    use_nosa = g[:, 4:5] & rnd_nosa.any(-1, keepdim=True)
    rnd = torch.where(use_nosa, rnd_nosa, playable)
    mask = torch.where(cap.any(-1, keepdim=True), cap,
                       torch.where(p3.any(-1, keepdim=True), p3, rnd))
    act = torch.where(mask, gumbel, float("-inf")).argmax(-1).to(torch.int32)
    return torch.where(mask.any(-1), act, nn)


def _uniform(shape, generator, device, low: float = 0.0) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return torch.clamp(u, min=low) if low else u


def _gumbel(shape, generator, device) -> torch.Tensor:
    """Gumbel draws as jax.random.gumbel makes them: -log(-log(u)), u
    uniform in [tiny, 1)."""
    u = _uniform(shape, generator, device, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@torch.inference_mode()
def mc_playout_batch(boards: torch.Tensor, amaf: torch.Tensor,
                     cfg: MichiConfig, last: Optional[torch.Tensor] = None,
                     last2: Optional[torch.Tensor] = None, *,
                     draws: Optional[dict] = None,
                     generator: Optional[torch.Generator] = None,
                     stats: Optional[dict] = None, return_final: bool = False):
    """Batched heuristic playouts to the end; returns (scores, amaf) with
    scores in {-1, 0, +1} for each board's side to move at entry
    (mcplayout's return convention, tree_search.py:216-219), and with
    ``return_final`` the final (B, N, N) int8 grids and (B,) sides to move.

    boards: (B, N, N, 17); amaf: (B, A) int8, updated with the first
    mover of each point.  last/last2: the two moves before the playout
    (the capture/pat3 locality window, tree_search.py:181-199); -1 = none.
    draws: {"gates": (S, B, 5), "gumbel": (S, B, N*N)} float32 per step,
    S = cfg.playout_cap(N); else drawn per step from ``generator``.

    Runs on signed stone grids; each step is one
    ``step_and_illegal_stones_batch`` (the gostep kernel on the card),
    whose next-mover legality feeds the next step (the first step's comes
    from the closure analysis).  The JAX scan runs
    all S steps; this loop ends once every board has passed twice (read
    every few steps), which changes no result: a finished board is
    frozen and the draws are indexed by step."""
    b, n = boards.shape[0], boards.shape[-3]
    nn = n * n
    dev = boards.device
    boards = boards.to(torch.int8)
    to_move = boards[:, 0, 0, 16].to(torch.int32)
    side = boards[:, 0, 0, 16].clone()
    stones = engine.signed_stones(boards)
    # the previous grid, for the first step's ko test: plane pair 1 holds
    # the side to move's and the opponent's stones one position ago
    prev = (boards[..., 2] - boards[..., 3]) * side[:, None, None]
    own = stones == side[:, None, None]
    illegal = H.illegal_from(
        H.closure_analysis(own, stones == -side[:, None, None]),
        (prev == side[:, None, None]) & ~own)
    full = torch.full((b,), -1, dtype=torch.int32, device=dev)
    last = full if last is None else last.to(dev, torch.int32)
    last2 = full if last2 is None else last2.to(dev, torch.int32)
    amaf = amaf.clone()
    passes = torch.zeros((b,), dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)
    steps = 0
    for s in range(cfg.playout_cap(n)):
        if s and s % _PLAYOUT_CHECK_EVERY == 0 and bool((passes >= 2).all()):
            break
        steps += 1
        if draws is not None:
            gates, gum = draws["gates"][s].to(dev), draws["gumbel"][s].to(dev)
        else:
            gates = _uniform((b, 5), generator, dev)
            gum = _gumbel((b, nn), generator, dev)
        done = passes >= 2
        actions = _playout_choose(stones, side, illegal, last, last2, cfg,
                                  gates, gum)
        any_move = actions < nn
        cur = amaf[rows, actions.long()]
        amaf[rows, actions.long()] = torch.where(
            any_move & (cur == 0) & ~done, side, cur)
        new_passes = torch.where(any_move, 0, passes + 1)
        frozen = done | (new_passes >= 2)
        # the game-ending second pass is not stepped (a pass changes no
        # stone anyway)
        new_stones, new_illegal = engine.step_and_illegal_stones_batch(
            stones, side, torch.where(frozen, nn, actions))
        stones = torch.where(frozen[:, None, None], stones, new_stones)
        illegal = torch.where(frozen[:, None], illegal, new_illegal)
        side = torch.where(frozen, side, -side)
        passes = torch.where(done, passes, new_passes)
        last, last2 = torch.where(done, last, actions), torch.where(done, last2, last)
    _count(stats, "playout_steps", steps)
    _count(stats, "scores")
    # minimal plane boards for area scoring (planes 0/1/16 only)
    fb = torch.zeros((b, n, n, NUM_PLANES), dtype=torch.int8, device=dev)
    fb[..., 0] = (stones == side[:, None, None]).to(torch.int8)
    fb[..., 1] = (stones == -side[:, None, None]).to(torch.int8)
    fb[..., 16] = side[:, None, None]
    winners, _, _ = engine.score_batch(fb, cfg.komi)
    scores = torch.where(winners == to_move, 1.0, -1.0)
    scores = torch.where(winners == 0, 0.0, scores)
    if return_final:
        return scores, amaf, stones, side
    return scores, amaf


# ---------------------------------------------------------------------------
# backup (tree_update parity)


def _update(tree: MichiTree, path_n, path_a, depth, leaf, score, amaf,
            active, levels: int) -> None:
    """Store one simulation in each tree, in place: wins along the path
    (for just-played) and AMAF stats on every expanded path node
    (tree_update tree_search.py:43-60).  ``levels`` >= max(depth).

    The JAX climb walks the path leaf to root flipping the score; the
    path's nodes are distinct, so all its levels are added at once, with
    the score at level i (from the leaf) score * (-1)^i.  Every addend is
    0 or 1, so the sums are exact in any order."""
    b = leaf.shape[0]
    dev = leaf.device
    bidx = torch.arange(b, device=dev)
    finc = active.to(torch.float32)

    def amaf_rows(x, sx, gate):
        """AMAF of rows x (B, L) with scores sx (B, L) where gate."""
        bi = bidx[:, None].expand_as(x)
        mover = tree.node_board[bi, x, 0, 0, 16]
        m = (amaf[:, None, :] == mover[..., None]) & tree.node_playable[bi, x]
        g = (gate & active[:, None])
        tree.edge_av.index_put_((bi, x), m.to(torch.int32) * g.to(
            torch.int32)[..., None], accumulate=True)
        tree.edge_aw.index_put_((bi, x), m.to(torch.float32) * (
            (sx > 0).to(torch.float32) * g.to(torch.float32))[..., None],
            accumulate=True)

    # leaf node AMAF (if expanded); score at leaf = score
    amaf_rows(leaf.clamp(min=0).long()[:, None], score[:, None],
              (leaf >= 0)[:, None])
    i = torch.arange(levels, device=dev)
    # edges leaf -> root: level i is path index depth-1-i
    j = (depth[:, None] - 1 - i[None]).clamp(0, path_n.shape[1] - 1).long()
    valid = i[None] < depth[:, None]
    p = torch.gather(path_n, 1, j).long()
    a = torch.gather(path_a, 1, j).clamp(min=0).long()
    s = score[:, None] * (1 - 2 * (i % 2)).to(torch.float32)[None]
    g = valid.to(torch.float32) * finc[:, None]
    # the edge child's to-play score is s; w counts wins for just-played
    tree.edge_w.index_put_((bidx[:, None].expand_as(p), p, a),
                           (s < 0).to(torch.float32) * g, accumulate=True)
    # AMAF at the parent node p with score for p's to-play = -s
    amaf_rows(p, -s, valid)
    s_root = score * (1 - 2 * (depth % 2)).to(torch.float32)
    tree.root_w += (s_root < 0).to(torch.float32) * finc


# ---------------------------------------------------------------------------
# the search loop


def best_root_stats(trees: MichiTree):
    """(actions (B,) int32, winrates (B,) f32) of each tree's most
    visited root child (best_move/winrate tree_node.py:100-105); the
    winrate is NaN without visits."""
    v = torch.where(trees.node_playable[:, 0], trees.edge_v[:, 0], -1)
    act = v.argmax(-1)
    bidx = torch.arange(act.shape[0], device=act.device)
    vv = trees.edge_v[bidx, 0, act].to(torch.float32)
    wr = torch.where(vv > 0, trees.edge_w[bidx, 0, act] / torch.clamp(vv, min=1.0),
                     float("nan"))
    return act.to(torch.int32), wr


def _round_draws(draws, r, k, b, max_depth, a_dim, steps, generator, dev):
    """(jitter(j, level) -> (B, A), playout draws or None) of round r."""
    if draws is not None:
        d = draws(r)
        jit = d["jitter"]
        return (lambda j, lvl: jit[j, lvl].to(dev)), {
            "gates": d["gates"], "gumbel": d["gumbel"]}
    return (lambda j, lvl: _uniform((b, a_dim), generator, dev) * 1e-6), None


@torch.inference_mode()
def michi_search_batch(trees: MichiTree, cfg: MichiConfig,
                       n_sims: Optional[int] = None, *,
                       active: Optional[torch.Tensor] = None,
                       sims_done: int = 0, total_sims: Optional[int] = None,
                       pattern_lut: Optional[torch.Tensor] = None,
                       draws: Optional[Callable[[int], dict]] = None,
                       generator: Optional[torch.Generator] = None,
                       stats: Optional[dict] = None):
    """Run up to n_sims simulations per tree in rounds of
    k = cfg.playout_parallel, with the reference's early stop
    (tree_search.py:127-130): a game stops once its best winrate exceeds
    fastplay5/fastplay20 past 5%/20% of the total budget, checked once a
    round.  ``sims_done``/``total_sims`` let one logical search span
    several calls (MichiSearcher); pass the returned ``active`` back in.

    draws(r) gives round r's draws: {"jitter": (k, D, B, A),
    "gates": (S, k*B, 5), "gumbel": (S, k*B, N*N)} float32, D =
    cfg.max_depth(N), S = cfg.playout_cap(N), the playout boards in
    (descent, game) order; else they come from ``generator`` (a
    generator seeded 0 on the trees' device when None).  ``stats``, a
    dict, counts rounds, playout steps, batched env steps, scores and the
    ladder reads' calls and iterations.

    Returns (trees, active); the input trees are left untouched."""
    n = cfg.n_sims if n_sims is None else n_sims
    total = cfg.n_sims if total_sims is None else total_sims
    k = max(1, int(cfg.playout_parallel))
    trees = trees.clone()
    b, c, a_dim = trees.node_playable.shape
    size = trees.node_board.shape[-2]
    dev = trees.edge_v.device
    if draws is None and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    active = (torch.ones((b,), dtype=torch.bool, device=dev) if active is None
              else torch.as_tensor(active, dtype=torch.bool).to(dev))
    bidx = torch.arange(b, device=dev)
    th5 = float(np.float32(total * 0.05))
    th20 = float(np.float32(total * 0.20))
    i, r = 0, 0
    while i < n and bool(active.any()):
        jitter, pdraws = _round_draws(draws, r, k, b, cfg.max_depth(size),
                                      a_dim, cfg.playout_cap(size),
                                      generator, dev)
        outs = [_descend(trees, active, cfg, lambda lvl, j=j: jitter(j, lvl))
                for j in range(k)]
        sp, sa, sc, pn, pa, d, amaf = (torch.stack(x) for x in zip(*outs))
        kb = k * b
        # boards at the far end of every stop edge: one batched env step
        stepped = engine.step_batch(
            trees.node_board[bidx[None], sp.long()].reshape(kb, size, size,
                                                            NUM_PLANES),
            sa.reshape(kb))
        _count(stats, "env_steps")
        a = H.closure_analysis(stepped[..., 0] == 1, stepped[..., 1] == 1)
        pv, pw = michi_priors(stepped, sa.reshape(kb), cfg, pattern_lut,
                              analysis=a, stats=stats)
        playable = playable_mask(stepped, a)
        stepped = stepped.reshape(k, b, size, size, NUM_PLANES)
        pv, pw, playable = (x.reshape(k, b, a_dim) for x in (pv, pw, playable))
        leaf = torch.stack([
            _expand(trees, sp[j], sa[j], sc[j], pv[j], pw[j], playable[j],
                    stepped[j], active, cfg.expand_visits) for j in range(k)])
        # playout boards: the stop node's stored board when the walk ended
        # at an existing node, else the stepped edge board
        child_boards = trees.node_board[bidx[None], sc.clamp(min=0).long()]
        leaf_b = torch.where((sc >= 0)[..., None, None, None], child_boards,
                             stepped)
        # locality seeds: the last two tree moves of each descent
        last = torch.gather(pa, 2, (d - 1).clamp(min=0).long()[..., None])[..., 0]
        last2 = torch.where(d >= 2, torch.gather(
            pa, 2, (d - 2).clamp(min=0).long()[..., None])[..., 0], -1)
        scores, amaf = mc_playout_batch(
            leaf_b.reshape(kb, size, size, NUM_PLANES), amaf.reshape(kb, a_dim),
            cfg, last.reshape(-1), last2.reshape(-1), draws=pdraws,
            generator=generator, stats=stats)
        scores, amaf = scores.reshape(k, b), amaf.reshape(k, b, a_dim)
        levels = int(d.max())
        # a node expanded this round sits at its descent's depth
        trees.height = max(trees.height, levels)
        for j in range(k):
            _update(trees, pn[j], pa[j], d[j], leaf[j], scores[j], amaf[j],
                    active, levels)
        _, wr = best_root_stats(trees)
        i += k
        r += 1
        done_total = float(np.float32(sims_done + i))
        fast5 = (done_total > th5) & (wr > cfg.fastplay5)
        fast20 = (done_total > th20) & (wr > cfg.fastplay20)
        active = active & ~(fast5 | fast20)
        _count(stats, "rounds")
    return trees, active


def michi_genmove_batch(boards: torch.Tensor, cfg: MichiConfig,
                        root_bonus=None, last_actions=None, pattern_lut=None,
                        draws=None, generator=None, stats=None):
    """(actions, winrates): search each board and pick the most visited
    move; callers may resign below cfg.resign_thres (conf.py:89)."""
    trees = new_michi_tree_batch(boards, cfg, last_actions, pattern_lut,
                                 root_bonus, stats=stats)
    trees, _ = michi_search_batch(trees, cfg, pattern_lut=pattern_lut,
                                  draws=draws, generator=generator,
                                  stats=stats)
    return best_root_stats(trees)


class MichiSearcher:
    """Chunked michi search: ``cfg.n_sims`` simulations in chunks of
    ``chunk_sims`` (at least k), the tree and the per-game ``active``
    carried across chunks and the fastplay thresholds computed against
    the whole budget, as the JAX package's searcher runs them.  On the
    card a chunk is just a host loop; the last chunk may overshoot the
    budget by up to a chunk less k, as in the JAX package.

    Draws come from ``draws(chunk, round)`` when given, else from a
    generator on ``device`` seeded with ``seed``.  ``stats`` accumulates
    the counts of ``michi_search_batch`` over every search."""

    def __init__(self, cfg: MichiConfig, chunk_sims: int = 256,
                 pattern_lut=None, device=None, seed: int = 0):
        from sejonggo_torch._device import resolve_device

        k = max(1, int(cfg.playout_parallel))
        self.cfg = cfg
        self.chunk = max(k, min(chunk_sims, cfg.n_sims))
        self.device = resolve_device(device)
        self.pattern_lut = (None if pattern_lut is None else torch.as_tensor(
            pattern_lut, dtype=torch.float32).to(self.device))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.stats: dict = {}

    def search(self, boards, last_actions=None, root_bonus=None, active=None,
               draws: Optional[Callable[[int, int], dict]] = None):
        """Full cfg.n_sims search; returns the final trees.  ``active``:
        optional (B,) bool — games to search; inactive games keep their
        fresh root untouched."""
        boards = torch.as_tensor(boards).to(self.device)
        b = boards.shape[0]
        if last_actions is not None:
            last_actions = torch.as_tensor(last_actions).to(self.device)
        trees = new_michi_tree_batch(boards, self.cfg, last_actions,
                                     self.pattern_lut, root_bonus,
                                     stats=self.stats)
        active = (torch.ones((b,), dtype=torch.bool, device=self.device)
                  if active is None
                  else torch.as_tensor(active, dtype=torch.bool).to(self.device))
        done, chunk = 0, 0
        while done < self.cfg.n_sims:
            trees, active = michi_search_batch(
                trees, self.cfg, n_sims=self.chunk, active=active,
                sims_done=done, pattern_lut=self.pattern_lut,
                draws=(None if draws is None
                       else (lambda r, c=chunk: draws(c, r))),
                generator=self.generator, stats=self.stats)
            done += self.chunk
            chunk += 1
            if not bool(active.any()):
                break
        return trees

    def genmove(self, boards, last_actions=None, root_bonus=None, draws=None):
        """(actions, winrates) of a full search."""
        return best_root_stats(self.search(boards, last_actions, root_bonus,
                                           draws=draws))
