"""Batched self-play and evaluation games (port of
sejonggo_tpu/actor/selfplay.py).

One call of the move step moves all B games in lockstep: root predict (no
symmetry), fresh trees where the previous tree has no expanded child to
reuse (with root Dirichlet noise in self-play), the batched search, the
decision, the env step, re-rooting, and the end flags (resignation, both
players passed).  Finished games are frozen by masks until the whole
batch ends.

Self-play shares one tree per game between both players.  Evaluation
(``predict2`` given) keeps one tree per model: the model to move searches
its own tree, and the chosen move advances both (reference
self_play.py:224-238).  ``play_games`` plays B games to the end and
returns their stacked records.

Random draws (the root Dirichlet noise, the D4 symmetries, the Gumbel
draws of temperature-1 moves) come from a CPU ``torch.Generator``, or
from a ``draws`` callable that hands in given values per move (the tests
pass JAX's).

With a ``mesh`` (``sejonggo_torch.parallel``) the game batch is split
over the ranks, as the JAX package shards it over 'dp': each rank plays
its B / mesh.size games with its rows of the thresholds, the colours and
the draws.  Side by side, the ranks' records are the records of one
batch, game by game up to each game's end; a rank's batch may end before
the global one, so only the padding rows after the end differ.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from sejonggo_torch._device import resolve_device
from sejonggo_torch.config import SearchConfig
from sejonggo_torch.goenv import engine
from sejonggo_torch.ops import check_kernel_errors
from sejonggo_torch.parallel import shard_actor_state, shard_batch
from sejonggo_torch.search import (advance_root_batch, decide_batch,
                                   new_tree_batch, policy_target_batch,
                                   run_search, sample_dirichlet, tree_where)
from sejonggo_torch.search.tree import Tree


@dataclasses.dataclass
class MoveState:
    boards: torch.Tensor        # (B, N, N, 17) int8
    trees: Tree                 # model 1's trees (the only ones in self-play)
    valid: torch.Tensor         # (B,) bool: trees hold a reusable search
    done: torch.Tensor          # (B,) bool
    skipped_last: torch.Tensor  # (B,) bool: the last move was a pass
    trees2: Optional[Tree] = None           # model 2's trees (evaluation)
    valid2: Optional[torch.Tensor] = None
    model1_isblack: Optional[torch.Tensor] = None  # (B,) bool


@dataclasses.dataclass
class GameBatch:
    """Stacked per-move records of B lockstep games (T = moves played)."""

    boards: np.ndarray          # (T, B, N, N, 17) int8: board before the move
    policy_targets: np.ndarray  # (T, B, A) f32
    values: np.ndarray          # (T, B) f32: predicted value at the move
    actions: np.ndarray         # (T, B) i32
    players: np.ndarray         # (T, B) i32: side that moved
    move_valid: np.ndarray      # (T, B) bool
    tree_fresh: np.ndarray      # (T, B) bool: a fresh tree was built
    winners: np.ndarray         # (B,) i32: area-score winner (+1/0/-1)
    resign_winners: np.ndarray  # (B,) i32: winner with resigns honoured
    black_points: np.ndarray    # (B,)
    white_points: np.ndarray    # (B,)
    end_reasons: np.ndarray     # (B,) 0 = move cap, 1 = both passed, 2 = resign
    num_moves: np.ndarray       # (B,) i32
    model1_isblack: np.ndarray  # (B,) bool

    def value_targets(self) -> np.ndarray:
        """(T, B) value targets from the area-score winner, as the
        reference saves them (sgfsave.py:60-66): 1 if the mover won, -1 if
        it lost, 0 for a draw."""
        w = self.winners[None, :]
        p = self.players
        return np.where(w == 0, 0.0, np.where(p == w, 1.0, -1.0)).astype(np.float32)


def planes_from_stones(stones: np.ndarray, players: np.ndarray) -> np.ndarray:
    """The 17 input planes of each move rebuilt from the per-move signed
    stone grids (T, ..., N, N) and movers (T, ...): plane pair q of move t
    is (stones_{t-q} == side_t, stones_{t-q} == -side_t), zeros before
    the game start; plane 16 is the side (reference play.py:226-242)."""
    t_len = stones.shape[0]
    boards = np.zeros(stones.shape + (17,), np.int8)
    s = players[..., None, None].astype(np.int8)
    for q in range(8):
        shifted = np.concatenate(
            [np.zeros((min(q, t_len),) + stones.shape[1:], np.int8),
             stones[: max(t_len - q, 0)]])
        boards[..., 2 * q] = shifted == s
        boards[..., 2 * q + 1] = shifted == -s
    boards[..., 16] = s
    return boards


def init_state(batch: int, size: int, search: SearchConfig, device=None,
               dual: bool = False, model1_isblack=None) -> MoveState:
    """B empty boards with placeholder trees (valid False, so the first
    move builds fresh trees); ``dual`` adds model 2's trees."""
    dev = resolve_device(device)
    boards = engine.init_board(size, batch=batch, device=dev)
    policy = torch.zeros((batch, size * size + 1), dtype=torch.float32,
                         device=dev)
    trees = new_tree_batch(policy, boards, search.capacity())
    zeros = torch.zeros((batch,), dtype=torch.bool, device=dev)
    state = MoveState(boards=boards.clone(), trees=trees, valid=zeros,
                      done=zeros.clone(), skipped_last=zeros.clone())
    if dual:
        state.trees2 = new_tree_batch(policy, boards, search.capacity())
        state.valid2 = zeros.clone()
        state.model1_isblack = (
            torch.ones((batch,), dtype=torch.bool, device=dev)
            if model1_isblack is None
            else torch.as_tensor(model1_isblack, dtype=torch.bool).to(dev))
    return state


def _select_predict(predict1: Callable, predict2: Callable,
                    model1_now: torch.Tensor) -> Callable:
    """The evaluation predict function of a flat leaf batch: model 1's
    where its game's mover is model 1, else model 2's.  Both nets run on
    every row and the rows are selected, as the JAX step does."""

    def both(flat):
        p1, v1 = predict1(flat)
        p2, v2 = predict2(flat)
        m = model1_now.repeat_interleave(flat.shape[0] // model1_now.shape[0])
        return (torch.where(m[:, None], p1, p2),
                torch.where(m[:, None], v1, v2))

    return both


def make_move_step(predict1: Callable, search: SearchConfig, size: int,
                   selfplay: bool = True, predict2: Optional[Callable] = None):
    """Build ``move_step(state, greedy, resign_thresholds, *, generator,
    noise, syms, gumbel) -> (state, record, flags)``.

    predict(boards (M, N, N, 17)) -> (policy (M, A), values (M, 1)).
    greedy: (B,) bool temperature-0 flags.  resign_thresholds: (B,)
    float, NaN = resignation off.  Random draws come from ``generator``
    (a CPU torch.Generator) unless given: ``noise`` (B, A) root Dirichlet
    noise (self-play only), ``syms`` one D4 id (or (B,) ids) per round,
    ``gumbel`` (B, A) sampling draws."""
    cap = search.capacity()
    dual = predict2 is not None

    def move_step(state: MoveState, greedy, resign_thresholds, *,
                  generator: torch.Generator | None = None,
                  noise: torch.Tensor | None = None, syms=None,
                  gumbel: torch.Tensor | None = None):
        boards = state.boards
        dev = boards.device
        b = boards.shape[0]
        player = boards[:, 0, 0, 16].to(torch.int32)
        if dual:
            model1_now = (player == 1) == state.model1_isblack
            predict_fn = _select_predict(predict1, predict2, model1_now)
        else:
            predict_fn = predict1

        policies, values = predict_fn(boards.to(torch.float32))
        values = values.reshape(b)
        thr = resign_thresholds.to(dev)
        resign_now = ~state.done & ~torch.isnan(thr) & (values <= thr)
        move_valid = ~state.done & ~resign_now

        if dual:
            active = tree_where(model1_now, state.trees, state.trees2)
            active_valid = torch.where(model1_now, state.valid, state.valid2)
            other = tree_where(model1_now, state.trees2, state.trees)
            other_valid = torch.where(model1_now, state.valid2, state.valid)
        else:
            active, active_valid = state.trees, state.valid

        if selfplay and noise is None:
            noise = sample_dirichlet(search.dirichlet_alpha, b,
                                     size * size + 1, generator).to(dev)
        fresh = new_tree_batch(policies, boards, cap,
                               noise=noise if selfplay else None,
                               epsilon=search.dirichlet_epsilon)
        tree_fresh = move_valid & ~active_valid
        active = tree_where(active_valid, active, fresh)
        # finished games keep their pre-search tree: the lockstep search
        # still runs on them, and their never re-rooted trees would
        # otherwise grow by `simulations` nodes a move
        active_before = active

        active = run_search(
            active, predict_fn, simulations=search.simulations,
            batch_size=search.batch_size, c_puct=search.c_puct,
            negamax=search.negamax, use_symmetry=search.use_symmetry,
            per_game_symmetry=not selfplay, syms=syms, generator=generator)
        actions = decide_batch(active, greedy, generator, gumbel=gumbel)
        ptargets = policy_target_batch(active, search.policy_target)

        pass_action = size * size
        actions = torch.where(move_valid, actions, pass_action)
        is_pass = actions == pass_action
        ended_bothpass = move_valid & state.skipped_last & is_pass

        new_boards = engine.step_batch(boards, actions)
        new_boards = torch.where(move_valid[:, None, None, None],
                                 new_boards, boards)
        adv, av = advance_root_batch(active, actions, new_boards,
                                     reserve=search.simulations)
        active = tree_where(move_valid, adv, active_before)
        active_valid = torch.where(move_valid, av, active_valid)

        trees2 = valid2 = None
        if dual:
            adv_o, ov = advance_root_batch(other, actions, new_boards,
                                           reserve=search.simulations)
            other = tree_where(move_valid & other_valid, adv_o, other)
            other_valid = torch.where(move_valid, other_valid & ov,
                                      other_valid)
            trees1 = tree_where(model1_now, active, other)
            valid1 = torch.where(model1_now, active_valid, other_valid)
            trees2 = tree_where(model1_now, other, active)
            valid2 = torch.where(model1_now, other_valid, active_valid)
        else:
            trees1, valid1 = active, active_valid

        stones = ((boards[..., 0] - boards[..., 1])
                  * player[:, None, None].to(boards.dtype)).to(torch.int8)
        record = dict(stones=stones, policy_targets=ptargets, values=values,
                      actions=actions, players=player,
                      move_valid=move_valid, tree_fresh=tree_fresh)
        new_state = MoveState(
            boards=new_boards, trees=trees1, valid=valid1,
            done=state.done | resign_now | ended_bothpass,
            skipped_last=torch.where(move_valid, is_pass, state.skipped_last),
            trees2=trees2, valid2=valid2,
            model1_isblack=state.model1_isblack)
        flags = dict(resign_now=resign_now, ended_bothpass=ended_bothpass)
        # the kernels do not synchronise: read their error word once a move
        check_kernel_errors(dev)
        return new_state, record, flags

    return move_step


def host_copy(tensors: dict) -> dict:
    """A dict of tensors as numpy arrays on the host."""
    return {k: v.cpu().numpy() for k, v in tensors.items()}


def play_games(predict1: Callable, predict2: Optional[Callable] = None, *,
               size: int, komi: float, search: SearchConfig, game_batch: int,
               generator: torch.Generator | None = None,
               selfplay: bool = True, stop_exploration: int = 30,
               resign_thresholds=None, model1_isblack=None,
               max_moves: Optional[int] = None, device=None,
               draws: Optional[Callable[[int], dict]] = None,
               mesh=None) -> GameBatch:
    """Play B games to the end; returns their stacked per-move records.

    predict fns: boards (M, N, N, 17) float32 -> (policy (M, A), values
    (M, 1)).  ``predict2`` turns on evaluation mode: model 1 plays black
    in game i iff ``model1_isblack[i]`` (default all True).  Moves before
    ``stop_exploration`` sample by visit counts, later ones are greedy.
    ``resign_thresholds``: (B,) floats, NaN = off (default all off).
    ``draws(move_n)``, when given, returns the keyword draws of that move
    (``noise``, ``syms``, ``gumbel``); otherwise they come from
    ``generator``.

    As in the JAX loop, the host reads move t's flags after it has
    started move t + 1, so the batch may take one extra move in which
    every game is masked; T counts it.

    ``mesh``: ``game_batch`` is the global batch and this rank plays and
    returns its share (``shard_batch`` of the thresholds, colours and
    each move's draws); ``generator`` draws for the rank's games only."""
    dev = resolve_device(device)
    b = game_batch
    if max_moves is None:
        max_moves = 2 * size * size
    thr = (np.full((b,), np.nan, np.float32) if resign_thresholds is None
           else np.asarray(resign_thresholds, np.float32))
    isblack = (np.ones((b,), bool) if model1_isblack is None
               else np.asarray(model1_isblack, bool).copy())
    if mesh is not None:
        if b % mesh.size:
            raise ValueError(
                f"game_batch={b} not divisible by mesh size {mesh.size}")
        thr, isblack = shard_batch(thr, mesh), shard_batch(isblack, mesh)
        b //= mesh.size
        if draws is not None:
            global_draws = draws
            draws = lambda move_n: shard_actor_state(  # noqa: E731
                global_draws(move_n), mesh)
    thr = torch.as_tensor(thr).to(dev)
    dual = predict2 is not None
    move_step = make_move_step(predict1, search, size, selfplay, predict2)
    state = init_state(b, size, search, device=dev, dual=dual,
                       model1_isblack=isblack)

    records = []
    flags_resign = np.zeros((b,), bool)
    flags_bothpass = np.zeros((b,), bool)
    resign_player = np.zeros((b,), np.int32)
    host_done = np.zeros((b,), bool)

    def process(pending):
        nonlocal resign_player
        rec, fl = host_copy(pending[0]), host_copy(pending[1])
        records.append(rec)
        rn = fl["resign_now"]
        # the resigner is the side to move when the resign fires
        resign_player = np.where(rn & ~flags_resign, rec["players"],
                                 resign_player)
        flags_resign[:] |= rn
        flags_bothpass[:] |= fl["ended_bothpass"]
        host_done[:] |= rn | fl["ended_bothpass"]

    pending = None
    for move_n in range(max_moves):
        greedy = torch.full((b,), move_n >= stop_exploration, device=dev)
        given = draws(move_n) if draws is not None else {}
        state, record, flags = move_step(state, greedy, thr,
                                         generator=generator, **given)
        if pending is not None:
            process(pending)
        pending = (record, flags)
        if host_done.all():
            break
    if pending is not None:
        process(pending)

    winners, black_pts, white_pts = engine.score_batch(state.boards, komi)
    winners = winners.cpu().numpy().astype(np.int32)
    move_valid = np.stack([r["move_valid"] for r in records])
    players = np.stack([r["players"] for r in records])
    end_reasons = np.where(flags_resign, 2, np.where(flags_bothpass, 1, 0))
    # resign-aware winner: the opponent of the resigner
    resign_winners = np.where(flags_resign, -resign_player, winners)
    return GameBatch(
        boards=planes_from_stones(np.stack([r["stones"] for r in records]),
                                  players),
        policy_targets=np.stack([r["policy_targets"] for r in records]),
        values=np.stack([r["values"] for r in records]),
        actions=np.stack([r["actions"] for r in records]),
        players=players,
        move_valid=move_valid,
        tree_fresh=np.stack([r["tree_fresh"] for r in records]),
        winners=winners,
        resign_winners=resign_winners.astype(np.int32),
        black_points=black_pts.cpu().numpy(),
        white_points=white_pts.cpu().numpy(),
        end_reasons=end_reasons.astype(np.int32),
        num_moves=move_valid.sum(0).astype(np.int32),
        model1_isblack=isblack,
    )
