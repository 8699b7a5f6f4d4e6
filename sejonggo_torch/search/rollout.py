"""Model-free search: heuristic priors + batched random rollouts (port of
sejonggo_tpu/search/rollout.py).

Reference counterpart: the michi-style engine in mcts1/ (prior
initialization tree_node.py:22-89, playouts tree_search.py:177-220) and
the nomodel self-play path (nomodel_self_play.py).  The exported
``make_heuristic_predict_fn`` has a network predict's signature,
predict(boards) -> (policies, values), so the batched MCTS, the actor and
the duel harness run the "9x9 model-free MCTS" configuration unchanged.

Heuristic prior features (weights loosely follow conf.py:84-105):
capture (the last liberty of an opponent group in atari), escape (the
last liberty of an own group in atari), local response around the
opponent's last move, a third/fourth-line bonus, and damping of moves
with at most one adjacent empty point.

Random draws are arguments: ``rollout_values`` takes the Gumbel draws of
its categorical moves, or draws them from a generator.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from sejonggo_torch.goenv import engine
from sejonggo_torch.goenv.engine import _group_minmax_lib, _shift_fill
from sejonggo_torch.ops.flood import dilate as _dilate

# prior weights (relative urgencies, cf. reference conf.py:97-104)
W_CAPTURE = 30.0
W_ESCAPE = 15.0
W_LOCAL = 6.0
W_LINE3 = 3.0
W_BASE = 1.0
W_SELF_ATARI = 0.1
W_PASS = 1e-3


def _atari_liberty_mask(stones: torch.Tensor, empty: torch.Tensor) -> torch.Tensor:
    """(B, N, N) float: 1 where a point is the single liberty of a
    ``stones`` group in atari."""
    b, n = stones.shape[0], stones.shape[-1]
    nn = n * n
    mn, mx = _group_minmax_lib(stones, empty)
    in_atari = stones & (mn == mx) & (mn < nn)
    idx = torch.where(in_atari, mn, nn).reshape(b, nn).long()
    hit = torch.zeros((b, nn + 1), dtype=torch.bool, device=stones.device)
    hit.scatter_(1, idx, True)
    return hit[:, :nn].reshape(b, n, n).to(torch.float32)


def heuristic_priors(boards: torch.Tensor) -> torch.Tensor:
    """(B, A) unnormalized move urgencies of (B, N, N, 17) boards."""
    b, n = boards.shape[0], boards.shape[-3]
    own, opp = boards[..., 0] == 1, boards[..., 1] == 1
    empty = ~(own | opp)
    capture = _atari_liberty_mask(opp, empty)
    escape = _atari_liberty_mask(own, empty)
    # opponent's last move: an opp stone now that wasn't there a move ago
    # (planes 1 vs 3 after the history shift)
    last = (boards[..., 1].to(torch.int32) - boards[..., 3].to(torch.int32)) == 1
    local = _dilate(_dilate(last)) | _dilate(last)
    i = torch.arange(n, dtype=torch.int32, device=boards.device)
    d = torch.minimum(i, n - 1 - i)
    edge_d = torch.minimum(d[:, None], d[None, :])
    line3 = (edge_d == 2) | (edge_d == 3)
    adj_empty = sum(_shift_fill(empty, dy, dx, False).to(torch.int32)
                    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)))
    w = (W_BASE + W_CAPTURE * capture + W_ESCAPE * escape
         + W_LOCAL * local.to(torch.float32) + W_LINE3 * line3.to(torch.float32))
    risky = (adj_empty <= 1) & (capture == 0)
    w = torch.where(risky, w * W_SELF_ATARI, w)
    w = torch.where(empty, w, 0.0)
    return torch.cat([w.reshape(b, n * n),
                      torch.full((b, 1), W_PASS, dtype=torch.float32,
                                 device=boards.device)], 1)


def _own_eye(boards: torch.Tensor) -> torch.Tensor:
    """(B, N, N) bool: single-point eyes of the side to move (all
    orthogonal neighbors own stones, off-board counts as own) — the
    playout no-eye-filling rule (michi's is_eyeish)."""
    own, opp = boards[..., 0] == 1, boards[..., 1] == 1
    surrounded = (_shift_fill(own, 1, 0, True) & _shift_fill(own, -1, 0, True)
                  & _shift_fill(own, 0, 1, True) & _shift_fill(own, 0, -1, True))
    return ~(own | opp) & surrounded


def rollout_values(boards: torch.Tensor, komi: float, num_steps: int = 0, *,
                   gumbel: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Batched random playouts of ``num_steps`` moves (0 = 2*N*N), then
    the area score: (B, 1) values in {-1, 0, +1} for each board's side to
    move (the role of mcplayout, tree_search.py:177-220).  Each move is
    uniform over the legal points that fill no own eye, pass when none
    remain: argmax over them of ``gumbel[step]`` ((S, B, N*N+1) float32,
    JAX's categorical), or of Gumbels drawn from ``generator``."""
    b, n = boards.shape[0], boards.shape[-3]
    nn = n * n
    if num_steps <= 0:
        num_steps = 2 * nn
    dev = boards.device
    to_move = boards[:, 0, 0, 16].to(torch.int32)
    for s in range(num_steps):
        if gumbel is not None:
            g = gumbel[s].to(dev)
        else:
            u = torch.rand((b, nn + 1), generator=generator, device=dev)
            g = -torch.log(-torch.log(torch.clamp(
                u, min=torch.finfo(torch.float32).tiny)))
        legal = ~engine.illegal_moves_mask_batch(boards)
        playable = legal[:, :nn] & ~_own_eye(boards).reshape(b, nn)
        act = torch.where(playable, g[:, :nn], float("-inf")).argmax(-1)
        act = torch.where(playable.any(-1), act, nn).to(torch.int32)
        boards = engine.step_batch(boards, act)
    winners, _, _ = engine.score_batch(boards, komi)
    val = torch.where(to_move == 1, winners, -winners).to(torch.float32)
    return val[:, None]


def make_heuristic_predict_fn(komi: float, rollout_steps: int = 0,
                              value_mode: str = "score", seed: int = 0,
                              draws: Optional[Callable] = None) -> Callable:
    """predict(boards) -> (policy (B, A), value (B, 1)) for the nomodel
    configuration.

    value_mode 'score': tanh-squashed area-score estimate of the current
    position.  value_mode 'rollout': batched random playouts.  The JAX
    package derives the rollouts' key from the board contents, so the
    function is pure; here ``draws(boards)`` gives the (S, B, N*N+1)
    Gumbel draws, else a CPU generator seeded with ``seed`` plus the sum
    of the boards draws them (pure as well)."""

    def predict(boards):
        n = boards.shape[-3]
        iboards = boards.to(torch.int8)
        priors = heuristic_priors(iboards)
        policy = priors / priors.sum(-1, keepdim=True)
        if value_mode == "rollout":
            if draws is not None:
                value = rollout_values(iboards, komi, rollout_steps,
                                       gumbel=draws(boards))
            else:
                mix = int(iboards.to(torch.int64).sum()) + seed
                g = torch.Generator(device=boards.device).manual_seed(mix)
                value = rollout_values(iboards, komi, rollout_steps,
                                       generator=g)
        else:
            _, black, white = engine.score_batch(iboards, komi)
            to_move = iboards[:, 0, 0, 16].to(torch.float32)
            value = torch.tanh((black - white) * to_move / (n * 2.0))[:, None]
        return policy, value

    return predict
