"""Random legal Go positions for checks: batched random games played
with the port's engine, moves chosen with numpy from a seed.

With ``contact`` > 0 a game prefers points next to a stone (capture
races and ko fights), as the JAX package's differential tests do.
"""
from __future__ import annotations

import numpy as np
import torch

from sejonggo_torch.goenv import engine


def choose_actions(rng: np.random.RandomState, illegal: np.ndarray,
                   occupied: np.ndarray, contact: float,
                   pass_prob: float) -> np.ndarray:
    """One legal action per row of ``illegal`` (G, N*N+1): a point next
    to a stone with probability ``contact`` when there is one, else any
    legal point, and pass with probability ``pass_prob`` or when no
    point is legal.  ``occupied``: (G, N, N) bool."""
    g, a = illegal.shape
    n = occupied.shape[-1]
    legal = ~illegal[:, :-1]
    pad = np.pad(occupied, ((0, 0), (1, 1), (1, 1)))
    near = (pad[:, :-2, 1:-1] | pad[:, 2:, 1:-1] | pad[:, 1:-1, :-2]
            | pad[:, 1:-1, 2:]).reshape(g, n * n)
    cand_contact = legal & near
    use_contact = (rng.rand(g) < contact) & cand_contact.any(1)
    cand = np.where(use_contact[:, None], cand_contact, legal)
    score = np.where(cand, rng.rand(g, n * n), -1.0)
    actions = score.argmax(1)
    actions = np.where((score.max(1) < 0) | (rng.rand(g) < pass_prob),
                       n * n, actions)
    return actions.astype(np.int32)


def random_positions(size: int, games: int, moves: int, seed: int,
                     contact: float = 0.0, pass_prob: float = 0.02,
                     device="cpu"):
    """Play ``games`` random legal games for ``moves`` moves each.
    Returns the position before every move and the move:
    (stones (games*moves, N, N) int8 black-positive, sides (games*moves,)
    int8 movers, actions (games*moves,) int32), on ``device``."""
    rng = np.random.RandomState(seed)
    boards = engine.init_board(size, batch=games, device=device)
    stones, sides, actions = [], [], []
    for _ in range(moves):
        illegal = engine.illegal_moves_mask_batch(boards).cpu().numpy()
        occ = ((boards[..., 0] == 1) | (boards[..., 1] == 1)).cpu().numpy()
        act = choose_actions(rng, illegal, occ, contact, pass_prob)
        stones.append(engine.signed_stones(boards))
        sides.append(boards[:, 0, 0, 16].to(torch.int8))
        act_t = torch.as_tensor(act, device=boards.device)
        actions.append(act_t)
        boards = engine.step_batch(boards, act_t)
    return (torch.stack(stones, 1).reshape(-1, size, size),
            torch.stack(sides, 1).reshape(-1),
            torch.stack(actions, 1).reshape(-1))
