"""Batched duel: the neural PUCT engine against the michi/RAVE engine
(port of sejonggo_tpu/learn/duel_michi.py).

B lockstep games, ordered as [net-plays-black half | net-plays-white
half].  All boards share one move parity, so at every move one half is
net-to-move and the other michi-to-move: each move is one batched net
search (tree reuse, per-game D4 symmetry, greedy moves: the evaluation
mode of actor/selfplay.py) and one batched michi search (a fresh RAVE
tree per move, as ``--engine michi`` plays over GTP).

Michi resigns a game when its root winrate drops below
MichiConfig.resign_thres (reference conf.py:89 RESIGN_THRES) — the net
then wins that game.  The net never resigns.  Other games end on
both-pass or the move cap and are scored by area.

Random draws: ``draws(move)`` gives a move's draws — {"syms": one (h,)
tensor of D4 ids per net search round, "michi": draws(chunk, round) for
the michi searcher} — else the net's come from ``generator`` (CPU) and
michi's from the searcher's generator on the device.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from sejonggo_torch._device import resolve_device
from sejonggo_torch.config import MichiConfig, SearchConfig
from sejonggo_torch.goenv import engine
from sejonggo_torch.ops import check_kernel_errors
from sejonggo_torch.search import (advance_root_batch, decide_batch,
                                   new_tree_batch, run_search, tree_where)
from sejonggo_torch.search.michi import MichiSearcher, best_root_stats


def _net_step(predict: Callable, search: SearchConfig, size: int, boards,
              trees, valid, done, *, syms=None, generator=None):
    """Net move for one half-batch: root predict, tree build or reuse,
    PUCT search, greedy decide, env step, re-root."""
    b = boards.shape[0]
    policies, _ = predict(boards.to(torch.float32))
    fresh = new_tree_batch(policies, boards, search.capacity())
    active = tree_where(valid, trees, fresh)
    active = run_search(
        active, predict, simulations=search.simulations,
        batch_size=search.batch_size, c_puct=search.c_puct,
        negamax=search.negamax, use_symmetry=search.use_symmetry,
        per_game_symmetry=True, syms=syms, generator=generator)
    actions = decide_batch(active, torch.ones((b,), dtype=torch.bool),
                           generator)
    actions = torch.where(done, size * size, actions)
    new_boards = engine.step_batch(boards, actions)
    new_boards = torch.where(done[:, None, None, None], boards, new_boards)
    trees, valid = advance_root_batch(active, actions, new_boards,
                                      reserve=search.simulations)
    return new_boards, trees, valid, actions


def _michi_step(searcher: MichiSearcher, search: SearchConfig, size: int,
                boards, net_trees, net_valid, done, last_actions, draws=None):
    """Michi move for one half-batch, and the net's tree advanced by it
    (the net keeps its reusable tree across opponent moves)."""
    michi = searcher.cfg
    trees = searcher.search(boards, last_actions=last_actions, active=~done,
                            draws=draws)
    acts, wrs = best_root_stats(trees)
    resign_now = ~done & (wrs < michi.resign_thres)
    stop = done | resign_now
    actions = torch.where(stop, size * size, acts)
    new_boards = engine.step_batch(boards, actions)
    new_boards = torch.where(stop[:, None, None, None], boards, new_boards)
    net_trees, tvalid = advance_root_batch(net_trees, actions, new_boards,
                                           reserve=search.simulations)
    net_valid = torch.where(stop, net_valid, net_valid & tvalid)
    return new_boards, net_trees, net_valid, actions, resign_now


@torch.inference_mode()
def play_vs_michi(predict: Callable, *, size: int, komi: float,
                  search: SearchConfig, michi: Optional[MichiConfig] = None,
                  game_batch: int, max_moves: Optional[int] = None,
                  progress_every: int = 0, device=None,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Callable[[int], dict]] = None,
                  seed: int = 0, chunk_sims: int = 256) -> dict:
    """Play ``game_batch`` games (half with the net as black) against the
    michi engine; returns the win rate and per-game records.

    predict(boards) -> (policies, values) on ``device`` (CUDA unless
    named).  Returned dict: games, net_wins, draws, michi_resigns,
    winrate, per-game arrays (winners, area_winners, black_points,
    white_points, net_isblack, num_moves), the move history (actions,
    players, move_valid: (T, B)), the final boards and ``counts``: the
    net and michi moves (half-batch calls), the host seconds they took
    (each ends in a host read of its moves) and the michi searcher's
    counts."""
    if game_batch % 2:
        raise ValueError("game_batch must be even (half per color)")
    dev = resolve_device(device)
    michi = dataclasses.replace(michi or MichiConfig(komi=komi), komi=komi)
    if max_moves is None:
        max_moves = 2 * size * size
    if generator is None and draws is None:
        generator = torch.Generator().manual_seed(seed)
    h = game_batch // 2
    searcher = MichiSearcher(michi, chunk_sims, device=dev, seed=seed)
    pass_action = size * size
    cap = search.capacity()
    counts = {"net_moves": 0, "michi_moves": 0, "net_seconds": 0.0,
              "michi_seconds": 0.0}

    halves = []
    for _ in range(2):
        boards = engine.init_board(size, batch=h, device=dev)
        dummy = torch.zeros((h, size * size + 1), dtype=torch.float32,
                            device=dev)
        halves.append(dict(
            boards=boards, trees=new_tree_batch(dummy, boards, cap),
            valid=torch.zeros((h,), dtype=torch.bool, device=dev),
            done=np.zeros((h,), bool), skipped=np.zeros((h,), bool),
            last=np.full((h,), -1, np.int32),
            resigned=np.zeros((h,), bool)))

    actions_hist, players_hist = [], []
    for move_n in range(max_moves):
        player = 1 if move_n % 2 == 0 else -1
        net_idx = 0 if player == 1 else 1
        net_h, mi_h = halves[net_idx], halves[1 - net_idx]
        d = draws(move_n) if draws is not None else {}
        acts_pair = [None, None]

        if not net_h["done"].all():
            t = time.perf_counter()
            nb, nt, nv, na = _net_step(
                predict, search, size, net_h["boards"], net_h["trees"],
                net_h["valid"], torch.as_tensor(net_h["done"]).to(dev),
                syms=d.get("syms"), generator=generator)
            net_h.update(boards=nb, trees=nt, valid=nv)
            na = na.cpu().numpy().astype(np.int32)
            counts["net_moves"] += 1
            counts["net_seconds"] += time.perf_counter() - t
        else:
            na = np.full((h,), pass_action, np.int32)
        acts_pair[net_idx] = na

        if not mi_h["done"].all():
            t = time.perf_counter()
            mb, mt, mv, ma, resign = _michi_step(
                searcher, search, size, mi_h["boards"], mi_h["trees"],
                mi_h["valid"], torch.as_tensor(mi_h["done"]).to(dev),
                torch.as_tensor(mi_h["last"]).to(dev), draws=d.get("michi"))
            mi_h.update(boards=mb, trees=mt, valid=mv)
            ma = ma.cpu().numpy().astype(np.int32)
            resign = resign.cpu().numpy()
            mi_h["resigned"] |= resign
            mi_h["done"] = mi_h["done"] | resign
            counts["michi_moves"] += 1
            counts["michi_seconds"] += time.perf_counter() - t
        else:
            ma = np.full((h,), pass_action, np.int32)
        acts_pair[1 - net_idx] = ma
        # the kernels do not synchronise: read their error word once a move
        check_kernel_errors(dev)

        for idx, acts in enumerate(acts_pair):
            hh = halves[idx]
            moved = ~hh["done"]
            is_pass = acts == pass_action
            ended = moved & hh["skipped"] & is_pass
            hh["skipped"] = np.where(moved, is_pass, hh["skipped"])
            hh["last"] = np.where(moved, acts, hh["last"])
            hh["done"] = hh["done"] | ended
        actions_hist.append(np.concatenate(acts_pair))
        players_hist.append(np.full((game_batch,), player, np.int32))
        if progress_every and (move_n + 1) % progress_every == 0:
            live = int((~halves[0]["done"]).sum() + (~halves[1]["done"]).sum())
            resigns = int(halves[0]["resigned"].sum()
                          + halves[1]["resigned"].sum())
            print(f"[duel] move {move_n + 1}: {live}/{game_batch} live, "
                  f"{resigns} michi resigns", file=sys.stderr, flush=True)
        if halves[0]["done"].all() and halves[1]["done"].all():
            break

    actions_arr = np.stack(actions_hist)            # (T, B)
    players_arr = np.stack(players_hist)
    # a recorded action is valid until the game's second consecutive pass
    t_len = actions_arr.shape[0]
    move_valid = np.zeros((t_len, game_batch), bool)
    for g in range(game_batch):
        skipped = False
        for t in range(t_len):
            a = actions_arr[t, g]
            move_valid[t, g] = True
            if a == pass_action and skipped and t > 0:
                break
            skipped = a == pass_action
    # michi resigns: strip the trailing pass padding after the resign
    resigned = np.concatenate([halves[0]["resigned"], halves[1]["resigned"]])
    for g in np.flatnonzero(resigned):
        nz = np.flatnonzero((actions_arr[:, g] != pass_action)
                            & move_valid[:, g])
        move_valid[(nz[-1] + 1) if nz.size else 0:, g] = False

    final = torch.cat([halves[0]["boards"], halves[1]["boards"]])
    winners, bp, wp = engine.score_batch(final, komi)
    winners = winners.cpu().numpy().astype(np.int32)
    net_isblack = np.concatenate([np.ones((h,), bool), np.zeros((h,), bool)])
    # a michi resign hands the game to the net whatever the area score
    net_color = np.where(net_isblack, 1, -1)
    effective = np.where(resigned, net_color, winners)
    net_won = (effective == net_color) & (effective != 0)
    counts.update({f"michi_{k}": v for k, v in searcher.stats.items()})
    return dict(
        games=game_batch,
        net_wins=int(net_won.sum()),
        draws=int((effective == 0).sum()),
        michi_resigns=int(resigned.sum()),
        winrate=float(net_won.mean()),
        winners=effective,
        area_winners=winners,
        black_points=bp.cpu().numpy(),
        white_points=wp.cpu().numpy(),
        net_isblack=net_isblack,
        actions=actions_arr,
        players=players_arr,
        move_valid=move_valid,
        num_moves=move_valid.sum(0).astype(np.int32),
        final_boards=final.cpu(),
        counts=counts,
    )


def save_michi_duel_sgfs(res: dict, *, size: int, komi: float, outdir: str,
                         prefix: str, net_name: str,
                         michi_name: str = "michi") -> int:
    """Write every duel game as SGF with RE/PB/PW (the evidence format of
    learn/duel.py save_gamebatch_sgfs; reference real_games/*.sgf)."""
    import os

    from sejonggo_torch.io.sgf import divmod_xy, game_to_sgf

    os.makedirs(outdir, exist_ok=True)
    t_len, b = res["actions"].shape
    for g in range(b):
        moves = [(int(res["players"][t, g]),
                  *divmod_xy(int(res["actions"][t, g]), size))
                 for t in range(t_len) if res["move_valid"][t, g]]
        w = int(res["winners"][g])
        if w == 0:
            result = "0"
        else:
            net_color = 1 if res["net_isblack"][g] else -1
            resigned = bool(res["michi_resigns"]) and \
                w == net_color and int(res["area_winners"][g]) != w
            if resigned:
                result = ("B" if w == 1 else "W") + "+R"
            else:
                margin = abs(float(res["black_points"][g])
                             - float(res["white_points"][g]))
                result = ("B" if w == 1 else "W") + f"+{margin:g}"
        black = net_name if res["net_isblack"][g] else michi_name
        white = michi_name if res["net_isblack"][g] else net_name
        with open(os.path.join(outdir, f"{prefix}_{g:03d}.sgf"), "w") as f:
            f.write(game_to_sgf(size, komi, moves, result,
                                black_name=black, white_name=white))
    return b
