"""The self-play move step (port of the one-net path of
sejonggo_tpu/actor/selfplay.py:_make_move_step).

One call moves all B games in lockstep: root predict (no symmetry), fresh
trees where the previous tree has no expanded child to reuse (with root
Dirichlet noise in self-play), the batched search, the decision, the env
step, re-rooting, and the end flags (resignation, both players passed).
Finished games are frozen by masks until the whole batch ends.

Not ported yet: the two-tree evaluation mode, ``play_games`` and the
resignation calibrator (actor/resign.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from sejonggo_torch._device import resolve_device
from sejonggo_torch.config import SearchConfig
from sejonggo_torch.goenv import engine
from sejonggo_torch.ops import check_kernel_errors
from sejonggo_torch.search import (advance_root_batch, decide_batch,
                                   new_tree_batch, policy_target_batch,
                                   run_search, sample_dirichlet, tree_where)
from sejonggo_torch.search.tree import Tree


@dataclasses.dataclass
class MoveState:
    boards: torch.Tensor        # (B, N, N, 17) int8
    trees: Tree
    valid: torch.Tensor         # (B,) bool: trees hold a reusable search
    done: torch.Tensor          # (B,) bool
    skipped_last: torch.Tensor  # (B,) bool: the last move was a pass


def init_state(batch: int, size: int, search: SearchConfig,
               device=None) -> MoveState:
    """B empty boards with placeholder trees (valid False, so the first
    move builds fresh trees)."""
    dev = resolve_device(device)
    boards = engine.init_board(size, batch=batch, device=dev)
    policy = torch.zeros((batch, size * size + 1), dtype=torch.float32,
                         device=dev)
    trees = new_tree_batch(policy, boards, search.capacity())
    zeros = torch.zeros((batch,), dtype=torch.bool, device=dev)
    return MoveState(boards=boards.clone(), trees=trees, valid=zeros,
                     done=zeros.clone(), skipped_last=zeros.clone())


def make_move_step(predict_fn: Callable, search: SearchConfig, size: int,
                   selfplay: bool = True):
    """Build ``move_step(state, greedy, resign_thresholds, *, generator,
    noise, syms) -> (state, record, flags)`` for one net.

    predict_fn(boards (M, N, N, 17)) -> (policy (M, A), values (M, 1)).
    greedy: (B,) bool temperature-0 flags.  resign_thresholds: (B,)
    float, NaN = resignation off.  Random draws come from ``generator``
    (a CPU torch.Generator): the root Dirichlet noise (self-play only;
    ``noise`` (B, A) overrides it), the D4 symmetry per round (``syms``
    overrides it, one entry per round) and the visit-count sampling."""
    cap = search.capacity()

    def move_step(state: MoveState, greedy, resign_thresholds, *,
                  generator: torch.Generator | None = None,
                  noise: torch.Tensor | None = None, syms=None):
        boards = state.boards
        dev = boards.device
        b = boards.shape[0]
        player = boards[:, 0, 0, 16].to(torch.int32)

        policies, values = predict_fn(boards.to(torch.float32))
        values = values.reshape(b)
        thr = resign_thresholds.to(dev)
        resign_now = ~state.done & ~torch.isnan(thr) & (values <= thr)
        move_valid = ~state.done & ~resign_now

        if selfplay and noise is None:
            noise = sample_dirichlet(search.dirichlet_alpha, b,
                                     size * size + 1, generator).to(dev)
        fresh = new_tree_batch(policies, boards, cap,
                               noise=noise if selfplay else None,
                               epsilon=search.dirichlet_epsilon)
        tree_fresh = move_valid & ~state.valid
        active = tree_where(state.valid, state.trees, fresh)
        active_before = active

        active = run_search(
            active, predict_fn, simulations=search.simulations,
            batch_size=search.batch_size, c_puct=search.c_puct,
            negamax=search.negamax, use_symmetry=search.use_symmetry,
            per_game_symmetry=not selfplay, syms=syms, generator=generator)
        actions = decide_batch(active, greedy, generator)
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
        trees = tree_where(move_valid, adv, active_before)
        valid = torch.where(move_valid, av, state.valid)

        stones = ((boards[..., 0] - boards[..., 1])
                  * player[:, None, None].to(boards.dtype)).to(torch.int8)
        record = dict(stones=stones, policy_targets=ptargets, values=values,
                      actions=actions, players=player,
                      move_valid=move_valid, tree_fresh=tree_fresh)
        new_state = MoveState(
            boards=new_boards, trees=trees, valid=valid,
            done=state.done | resign_now | ended_bothpass,
            skipped_last=torch.where(move_valid, is_pass, state.skipped_last))
        flags = dict(resign_now=resign_now, ended_bothpass=ended_bothpass)
        # the kernels do not synchronise: read their error word once a move
        check_kernel_errors(dev)
        return new_state, record, flags

    return move_step
