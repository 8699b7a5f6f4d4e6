"""The gate: latest against best (port of sejonggo_tpu/learn/evaluate.py).

Reference evaluator.py:23-47: EVALUATE_N_GAMES games of latest against
best, with a random colour per game (choose_first_player play.py:301-306);
latest is promoted when its win rate exceeds EVALUATE_MARGIN (0.55).  The
match runs as a few lockstep batches of two-tree evaluation games
(``play_games`` with two models).  Each game's winner is its area score,
as in the reference (resignation is off in evaluation).  With a ``mesh``
each batch is padded to a multiple of the mesh size, as in the JAX
package, each rank plays its share of it, and the counts are summed over
the ranks, so every rank returns the whole match's win rate.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from sejonggo_torch.actor.selfplay import play_games
from sejonggo_torch.config import EvalConfig, SearchConfig
from sejonggo_torch.parallel import shard_batch


def evaluate_models(predict_latest: Callable, predict_best: Callable, *,
                    size: int, komi: float, search: SearchConfig,
                    eval_cfg: EvalConfig,
                    generator: torch.Generator | None = None,
                    game_batch: int = 0, stop_exploration: int = 0,
                    max_moves=None, collect_games: bool = False,
                    device=None,
                    colors: Optional[Callable[[int], np.ndarray]] = None,
                    draws: Optional[Callable[[int, int], dict]] = None,
                    mesh=None) -> Dict:
    """Play eval_cfg.num_games games of latest (model 1) against best;
    returns the win rate, ``promote`` and game statistics.

    Games run in batches of ``game_batch`` (default: all at once).  Each
    batch draws latest's colour per game uniformly from ``generator``,
    or takes ``colors(batch_index)`` ((b,) bool, True = latest is black).
    ``draws(batch_index, move_n)``, when given, supplies a batch's
    per-move draws (see ``play_games``).  With a ``mesh``, ``colors`` and
    ``draws`` give the whole (padded) batch's values, of which this rank
    takes its rows; ``game_batches`` holds this rank's games."""
    n = eval_cfg.num_games
    if game_batch <= 0:
        game_batch = n
    wins = draws_n = played = 0
    num_moves = []
    collected = []
    batch_i = 0
    while played < n:
        b = min(game_batch, n - played)
        if mesh is not None and b % mesh.size:
            b += mesh.size - b % mesh.size  # keep the batch shardable
        if colors is not None:
            latest_isblack = np.asarray(colors(batch_i), bool)
        else:
            latest_isblack = (torch.rand((b,), generator=generator)
                              < 0.5).numpy()
        games = play_games(
            predict_latest, predict_best, size=size, komi=komi,
            search=search, game_batch=b, generator=generator,
            selfplay=False, stop_exploration=stop_exploration,
            model1_isblack=latest_isblack, max_moves=max_moves,
            device=device, mesh=mesh,
            draws=(None if draws is None
                   else (lambda m, i=batch_i: draws(i, m))))
        if mesh is not None:
            latest_isblack = shard_batch(latest_isblack, mesh)
        latest_won = ((games.winners == 1) == latest_isblack) & (games.winners != 0)
        wins += int(latest_won.sum())
        draws_n += int((games.winners == 0).sum())
        played += b
        num_moves.extend(games.num_moves.tolist())
        if collect_games:
            collected.append(games)
        batch_i += 1
    moves_sum, moves_n = sum(num_moves), len(num_moves)
    if mesh is not None:
        wins, draws_n, moves_sum, moves_n = map(int, mesh.sum_counts(
            [wins, draws_n, moves_sum, moves_n]))
    winrate = wins / played
    out = {
        "winrate": winrate,
        "wins": wins,
        "draws": draws_n,
        "games": played,
        "promote": winrate > eval_cfg.margin,   # evaluator.py:43
        "mean_moves": moves_sum / moves_n,
    }
    if collect_games:
        # evaluation games double as training data (reference
        # evaluate_worker.py:151)
        out["game_batches"] = collected
    return out
