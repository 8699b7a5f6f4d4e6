"""Continuous self-play: finished games respawn in place (port of
sejonggo_tpu/actor/continuous.py).

``play_games`` steps a fixed batch until all games finish, so slots idle
while the longest games drain.  Here every slot is always live: a game
that ends (resign, both passed, move cap) is scored on the board after
its last move and respawned as a fresh game inside the same step.  The
host keeps a ring of per-step records and harvests each finished game,
with the value targets of its winner, when its slot ends.

Random draws come from a CPU ``torch.Generator``, or from a ``draws``
callable that hands in given values per step (the tests pass JAX's).
The JAX actor's ``selfplay`` flag is not ported: no caller turns it off,
so the slots always play self-play moves (root noise, one search
symmetry for the batch).

With a ``mesh`` (``sejonggo_torch.parallel``) the slots are split over
the ranks, as the JAX actor shards them over 'dp': each rank runs its
game_batch / mesh.size slots with its rows of each step's draws, and
``run(num_games)`` harvests this rank's share of the games (the ranges of
``local_game_slice``), so the ranks need no collective while they play.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from sejonggo_torch._device import resolve_device
from sejonggo_torch.actor.selfplay import (MoveState, host_copy,
                                           make_move_step, planes_from_stones)
from sejonggo_torch.config import SearchConfig
from sejonggo_torch.goenv import engine
from sejonggo_torch.ops import check_kernel_errors
from sejonggo_torch.parallel import shard_actor_state
from sejonggo_torch.search import new_tree_batch
from sejonggo_torch.search.tree import Tree


@dataclasses.dataclass
class SlotState:
    boards: torch.Tensor        # (B, N, N, 17) int8
    trees: Tree
    tree_valid: torch.Tensor    # (B,) bool
    skipped_last: torch.Tensor  # (B,) bool
    move_n: torch.Tensor        # (B,) int32: moves played in the slot's game


def make_continuous_step(predict: Callable, search: SearchConfig, size: int,
                         stop_exploration: int, max_moves: int, komi: float):
    """Build ``cstep(state, resign_thresholds, *, generator, noise, syms,
    gumbel) -> (state, record)``: the self-play move step of ``play_games``
    in every slot (no slot is ever done), then the score of every slot on
    the board after the move, then the respawn of the slots whose game
    ended."""
    move_step = make_move_step(predict, search, size, selfplay=True)

    def cstep(state: SlotState, resign_thresholds, *,
              generator: torch.Generator | None = None,
              noise: torch.Tensor | None = None, syms=None,
              gumbel: torch.Tensor | None = None):
        boards = state.boards
        moved, record, flags = move_step(
            MoveState(boards=boards, trees=state.trees,
                      valid=state.tree_valid,
                      done=torch.zeros_like(state.skipped_last),
                      skipped_last=state.skipped_last),
            state.move_n >= stop_exploration, resign_thresholds,
            generator=generator, noise=noise, syms=syms, gumbel=gumbel)
        resign_now = flags["resign_now"]
        ended_cap = record["move_valid"] & (state.move_n + 1 >= max_moves)
        ended = resign_now | flags["ended_bothpass"] | ended_cap

        # every slot is scored (area winner on the board after the move,
        # the reference rule; a resign's winner is the resigner's opponent)
        area_winner, bp, wp = engine.score_batch(moved.boards, komi)
        record.update(
            ended=ended, area_winner=area_winner,
            resign_winner=torch.where(resign_now, -record["players"],
                                      area_winner),
            resigned=resign_now, black_points=bp, white_points=wp)
        fresh_board = engine.init_board(size, device=boards.device)
        new_state = SlotState(
            boards=torch.where(ended[:, None, None, None],
                               fresh_board.to(boards.dtype), moved.boards),
            trees=moved.trees, tree_valid=moved.valid & ~ended,
            skipped_last=moved.skipped_last & ~ended,
            move_n=torch.where(ended, 0, state.move_n + 1))
        return new_state, record

    return cstep


class ContinuousSelfPlay:
    """Streaming self-play over B always-live slots.

    ``threshold_fn()`` gives each new game its resign threshold (NaN =
    off, the default), fixed for the game's life.  ``draws(step)``, when
    given, returns the keyword draws of that step (``noise``, ``syms``,
    ``gumbel``); otherwise they come from ``generator``.  With a ``mesh``
    this rank holds game_batch / mesh.size of the slots (``self.b``), and
    ``draws`` hands in the whole batch's draws, of which it takes its
    rows."""

    def __init__(self, predict: Callable, *, size: int, komi: float,
                 search: SearchConfig, game_batch: int,
                 stop_exploration: int = 30,
                 max_moves: Optional[int] = None,
                 generator: torch.Generator | None = None,
                 threshold_fn: Optional[Callable[[], float]] = None,
                 device=None, draws: Optional[Callable[[int], dict]] = None,
                 mesh=None):
        dev = resolve_device(device)
        self.size = size
        self.mesh = mesh
        self.b = game_batch
        if mesh is not None:
            if game_batch % mesh.size:
                raise ValueError(
                    f"game_batch={game_batch} not divisible by mesh size "
                    f"{mesh.size}")
            self.b = game_batch // mesh.size
            if draws is not None:
                global_draws = draws
                draws = lambda step: shard_actor_state(  # noqa: E731
                    global_draws(step), mesh)
        self.generator = generator
        self.draws = draws
        self.max_moves = max_moves or 2 * size * size
        self._step = make_continuous_step(
            predict, search, size, stop_exploration,
            self.max_moves, komi)
        boards = engine.init_board(size, batch=self.b, device=dev)
        trees = new_tree_batch(
            torch.zeros((self.b, size * size + 1), dtype=torch.float32,
                        device=dev), boards, search.capacity())
        zeros = torch.zeros((self.b,), dtype=torch.bool, device=dev)
        self.state = SlotState(
            boards=boards.clone(), trees=trees, tree_valid=zeros,
            skipped_last=zeros.clone(),
            move_n=torch.zeros((self.b,), dtype=torch.int32, device=dev))
        # the host ring holds a step's records for the whole batch; a
        # live game spans at most max_moves steps
        w = self.max_moves + 1
        a = size * size + 1
        self._ring = {
            "stones": np.zeros((w, self.b, size, size), np.int8),
            "policy_targets": np.zeros((w, self.b, a), np.float32),
            "values": np.zeros((w, self.b), np.float32),
            "actions": np.zeros((w, self.b), np.int32),
            "players": np.zeros((w, self.b), np.int32),
            "move_valid": np.zeros((w, self.b), bool),
        }
        self._ring_w = w
        self._start = np.zeros((self.b,), np.int64)  # first step of the
        #                                              slot's current game
        self._gstep = 0    # steps harvested (the device may run one ahead)
        self._threshold_fn = threshold_fn or (lambda: float("nan"))
        self._thresholds = np.asarray(
            [self._threshold_fn() for _ in range(self.b)], np.float32)
        self.steps = 0
        self.games_finished = 0
        self.empty_games = 0  # zero-move instant resigns (dropped)
        self.moves_recorded = 0
        self.fresh_trees = 0  # tree_fresh occurrences (reuse-rate metric)

    @property
    def tree_fresh_rate(self) -> float:
        """Fraction of recorded moves that built their tree from scratch
        (1 - the reuse rate)."""
        return self.fresh_trees / max(self.moves_recorded, 1)

    def _harvest_game(self, g: int, rec) -> Dict:
        """Slot g's finished game from the step ring as stacked arrays
        (T = recorded moves), with the 17 planes rebuilt from the grids."""
        idxs = np.arange(self._start[g], self._gstep + 1) % self._ring_w
        sel = idxs[self._ring["move_valid"][idxs, g]]
        players = self._ring["players"][sel, g]
        return {
            "boards": planes_from_stones(self._ring["stones"][sel, g], players),
            "policies": self._ring["policy_targets"][sel, g],
            "values": self._ring["values"][sel, g],
            "actions": self._ring["actions"][sel, g],
            "players": players,
            "winner": int(rec["area_winner"][g]),
            "resign_winner": int(rec["resign_winner"][g]),
            "resigned": bool(rec["resigned"][g]),
            "black_points": float(rec["black_points"][g]),
            "white_points": float(rec["white_points"][g]),
            "holdout": bool(np.isnan(self._thresholds[g])),
        }

    def run(self, num_games: int, thresholds_fn=None, on_game=None,
            keep_empty: bool = False, max_steps: Optional[int] = None):
        """Play until ``num_games`` games finish; returns their dicts.

        Each game dict carries stacked per-move arrays (boards, policies,
        values, actions, players) and its outcome.  thresholds_fn(b) ->
        (B,) overrides the per-game thresholds for a step; on_game(game)
        is called per finished game; max_steps bounds the steps of this
        call.  As in the JAX loop, step t's record is read after step
        t + 1 has started, so a respawned game's first step still runs
        under its slot's previous threshold.  With a mesh, ``num_games``
        is the count over every rank and this rank plays its share."""
        if self.mesh is not None:
            num_games = len(self.mesh.game_slice(num_games))
        finished = []
        dev = self.state.boards.device

        def process(record):
            rec = host_copy(record)
            w = self._gstep % self._ring_w
            for k, buf in self._ring.items():
                buf[w] = rec[k]
            self.moves_recorded += int(rec["move_valid"].sum())
            self.fresh_trees += int(rec["tree_fresh"].sum())
            for g in np.nonzero(rec["ended"])[0]:
                game = self._harvest_game(int(g), rec)
                self._start[g] = self._gstep + 1
                self._thresholds[g] = self._threshold_fn()
                if game["boards"].shape[0] == 0 and not keep_empty:
                    # zero-move (instant-resign) games carry no data; the
                    # reference deletes them (selfplay_worker.py:115-118)
                    self.empty_games += 1
                    continue
                self.games_finished += 1
                finished.append(game)
                if on_game is not None:
                    on_game(game)
            self._gstep += 1

        pending = None
        first_step = self.steps
        while len(finished) < num_games and (
                max_steps is None or self.steps - first_step < max_steps):
            thr = (np.asarray(thresholds_fn(self.b), np.float32)
                   if thresholds_fn is not None else self._thresholds.copy())
            given = self.draws(self.steps) if self.draws is not None else {}
            self.state, record = self._step(
                self.state, torch.from_numpy(thr).to(dev),
                generator=self.generator, **given)
            self.steps += 1
            if pending is not None:
                process(pending)
            pending = record
        if pending is not None:
            process(pending)
        # the move step reads the kernels' error word before its score;
        # the last step's score floods are read here
        check_kernel_errors(dev)
        return finished
