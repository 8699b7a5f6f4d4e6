"""Duel harness: pit two engines for N games (port of
sejonggo_tpu/learn/duel.py).

Reference counterpart: test/play_test.py:12-37 (two named checkpoints)
and the real_games/ SGFs against GNU Go.  Opponent kinds:

- a checkpoint name from a CheckpointStore (or 'best' / 'latest'),
- 'heuristic' — the rollout-prior predict function (search.rollout),
- 'dummy' — the deterministic stub net,
- 'michi' (as --b) — the michi/RAVE engine (learn/duel_michi.py),
- --gtp '<command>' — an external GTP engine subprocess, played move by
  move through GoEngine.

CLI: python -m sejonggo_torch.learn.duel --a model_291 --b michi \
        --michi-sims 64 --games 32 --preset xl \
        --model-dir runs/strength_r5b/sp_models [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import subprocess
from typing import Callable, Optional

import torch

from sejonggo_torch._device import resolve_device
from sejonggo_torch.config import (Config, EvalConfig, MichiConfig,
                                   full_19x19, small_9x9, strength_9x9,
                                   strength_9x9_xl)
from sejonggo_torch.learn.evaluate import evaluate_models

PRESETS = {"tiny": small_9x9, "strength": strength_9x9,
           "xl": strength_9x9_xl, "full": full_19x19}


def elo_diff(winrate: float) -> float:
    """Winrate -> Elo difference (clamped)."""
    w = min(max(winrate, 1e-3), 1 - 1e-3)
    return -400.0 * math.log10(1.0 / w - 1.0)


def _resolve(name: str, cfg: Config, model_dir: str, device) -> Callable:
    """predict(boards) -> (policies, values) on ``device`` for an
    opponent spec."""
    if name == "heuristic":
        from sejonggo_torch.search.rollout import make_heuristic_predict_fn

        return make_heuristic_predict_fn(cfg.go.komi)
    if name == "dummy":
        from sejonggo_torch.nets import dummy_predict_fn

        return dummy_predict_fn
    from sejonggo_torch.learn import CheckpointStore
    from sejonggo_torch.nets import AZNet, from_jax_variables, make_predict_fn

    store = CheckpointStore(model_dir)
    if name == "best":
        name = store.best_name()
    elif name == "latest":
        name = store.latest_name()
    net = AZNet.from_config(cfg.go.size, cfg.net)
    net.load_state_dict(from_jax_variables(store.load_variables(name)))
    return make_predict_fn(net.to(device))


def save_gamebatch_sgfs(gb, *, size: int, komi: float, outdir: str,
                        prefix: str, a_name: str, b_name: str) -> int:
    """Write every game of a GameBatch as an SGF with RE/PB/PW (the
    reference committed its evidence games the same way,
    real_games/*.sgf; sgfsave.py:130-167 layout)."""
    import os

    from sejonggo_torch.io.sgf import divmod_xy, game_to_sgf

    os.makedirs(outdir, exist_ok=True)
    t_len, b = gb.actions.shape
    for g in range(b):
        moves = [(int(gb.players[t, g]),
                  *divmod_xy(int(gb.actions[t, g]), size))
                 for t in range(t_len) if gb.move_valid[t, g]]
        w = int(gb.winners[g])
        if w == 0:
            result = "0"
        else:
            margin = abs(float(gb.black_points[g]) - float(gb.white_points[g]))
            result = ("B" if w == 1 else "W") + f"+{margin:g}"
        a_black = bool(gb.model1_isblack[g])
        with open(os.path.join(outdir, f"{prefix}_{g:03d}.sgf"), "w") as f:
            f.write(game_to_sgf(
                size, komi, moves, result,
                values=[float(v) for v in gb.values[:, g]][:len(moves)],
                black_name=a_name if a_black else b_name,
                white_name=b_name if a_black else a_name))
    return b


def duel(a: str, b: str, *, cfg: Config, model_dir: str, games: int,
         seed: int = 0, max_moves: Optional[int] = None,
         sgf_dir: Optional[str] = None, michi_sims: Optional[int] = None,
         device=None, colors=None, draws=None,
         michi_draws: Optional[Callable[[int], dict]] = None) -> dict:
    """``games`` games of ``a`` against ``b``.  Two predict functions play
    through ``evaluate_models`` in batches of up to 32 (colours and draws
    from a generator seeded with ``seed``, or ``colors``/``draws`` as
    evaluate_models takes them); ``b == 'michi'`` plays ``a`` against the
    michi engine at ``michi_sims`` through ``play_vs_michi`` (its draws
    ``michi_draws``)."""
    dev = resolve_device(device)
    predict_a = _resolve(a, cfg, model_dir, dev)
    if b == "michi":
        from sejonggo_torch.learn.duel_michi import (play_vs_michi,
                                                     save_michi_duel_sgfs)

        michi_cfg = MichiConfig(komi=cfg.go.komi)
        if michi_sims:
            michi_cfg = dataclasses.replace(michi_cfg, n_sims=michi_sims)
        res = play_vs_michi(
            predict_a, size=cfg.go.size, komi=cfg.go.komi, search=cfg.search,
            michi=michi_cfg, game_batch=games, max_moves=max_moves,
            progress_every=10, device=dev, seed=seed, draws=michi_draws)
        if sgf_dir is not None:
            save_michi_duel_sgfs(
                res, size=cfg.go.size, komi=cfg.go.komi, outdir=sgf_dir,
                prefix=f"{a}_vs_michi{michi_cfg.n_sims}", net_name=a,
                michi_name=f"michi-{michi_cfg.n_sims}")
        out = {k: res[k] for k in ("games", "winrate", "net_wins", "draws",
                                   "michi_resigns")}
        out["wins"] = res["net_wins"]
        out["mean_moves"] = float(res["num_moves"].mean())
        out["a"], out["b"] = a, f"michi@{michi_cfg.n_sims}"
        out["elo_diff_a_vs_b"] = elo_diff(res["winrate"])
        return out
    predict_b = _resolve(b, cfg, model_dir, dev)
    res = evaluate_models(
        predict_a, predict_b, size=cfg.go.size, komi=cfg.go.komi,
        search=cfg.search, eval_cfg=EvalConfig(num_games=games, margin=0.5),
        generator=torch.Generator().manual_seed(seed),
        game_batch=min(games, 32), max_moves=max_moves,
        collect_games=sgf_dir is not None, device=dev, colors=colors,
        draws=draws)
    if sgf_dir is not None:
        for i, gb in enumerate(res.pop("game_batches", [])):
            save_gamebatch_sgfs(
                gb, size=cfg.go.size, komi=cfg.go.komi, outdir=sgf_dir,
                prefix=f"{a}_vs_{b}_b{i}", a_name=a, b_name=b)
    res["a"], res["b"] = a, b
    res["elo_diff_a_vs_b"] = elo_diff(res["winrate"])
    return res


class GTPSubprocessEngine:
    """Drive an external GTP engine (GNU Go etc.) over a pipe — the
    counterpart of the reference's manual GoGui/Sabaki matches."""

    def __init__(self, command: str, size: int, komi: float):
        self.proc = subprocess.Popen(
            command.split(), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, bufsize=1)
        self._cmd(f"boardsize {size}")
        self._cmd(f"komi {komi}")
        self._cmd("clear_board")

    def _cmd(self, line: str) -> str:
        assert self.proc.stdin and self.proc.stdout
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()
        out = []
        while True:
            resp = self.proc.stdout.readline()
            if resp.strip() == "" and out:
                break
            if resp == "":
                break
            out.append(resp.rstrip("\n"))
        text = "\n".join(out).strip()
        if text.startswith("?"):
            raise RuntimeError(f"GTP error for {line!r}: {text}")
        return text.lstrip("= ").strip()

    def play(self, color: str, vertex: str):
        self._cmd(f"play {color} {vertex}")

    def genmove(self, color: str) -> str:
        return self._cmd(f"genmove {color}")

    def close(self):
        try:
            self._cmd("quit")
        except Exception:  # noqa: BLE001 — the engine may be gone already
            pass
        self.proc.terminate()
        self.proc.wait()


def duel_vs_gtp(checkpoint: str, gtp_command: str, *, cfg: Config,
                model_dir: str, games: int, seed: int = 0,
                our_color_first: str = "B", device=None) -> dict:
    """Alternating-colour match of one of our engines against an external
    GTP engine; the winner by our area scoring of the final position."""
    from sejonggo_torch.goenv import engine as ge
    from sejonggo_torch.goenv import gtp_to_xy, xy_to_gtp
    from sejonggo_torch.io.gtp import GoEngine

    dev = resolve_device(device)
    predict = _resolve(checkpoint, cfg, model_dir, dev)
    size, komi = cfg.go.size, cfg.go.komi
    wins = 0
    for g in range(games):
        ours_black = (g % 2 == 0) == (our_color_first == "B")
        eng = GoEngine(predict, size=size, komi=komi, search=cfg.search,
                       seed=seed + g, device=dev)
        ext = GTPSubprocessEngine(gtp_command, size, komi)
        passes = 0
        for move_n in range(2 * size * size):
            black_turn = move_n % 2 == 0
            if black_turn == ours_black:
                x, y, _ = eng.genmove(1 if black_turn else -1)
                vertex = xy_to_gtp(x, y, size)
                ext.play("B" if black_turn else "W", vertex)
            else:
                vertex = ext.genmove("B" if black_turn else "W")
                if vertex.lower() == "resign":
                    passes = 99
                    break
                x, y = gtp_to_xy(vertex, size)
                eng.play(1 if black_turn else -1, x, y)
            passes = passes + 1 if y >= size else 0
            if passes >= 2:
                break
        ext.close()
        if passes == 99:
            wins += 1  # the external engine resigned
        else:
            w = int(ge.winner(eng.board, komi))
            if (w == 1) == ours_black and w != 0:
                wins += 1
    winrate = wins / games
    return {"wins": wins, "games": games, "winrate": winrate,
            "elo_diff": elo_diff(winrate)}


def main(argv=None):
    parser = argparse.ArgumentParser(description="sejonggo_torch duel harness")
    parser.add_argument(
        "--a", required=True,
        help="checkpoint name | best | latest | heuristic | dummy")
    parser.add_argument("--b", required=True,
                        help="same as --a, plus 'michi' (the RAVE engine, "
                        "search/michi.py)")
    parser.add_argument("--michi-sims", type=int, default=None,
                        help="override MichiConfig.n_sims for --b michi")
    parser.add_argument("--max-moves", type=int, default=None,
                        help="move cap per game (default 2*N^2); capped "
                        "games are area-scored")
    parser.add_argument("--games", type=int, default=8)
    parser.add_argument("--preset", choices=sorted(PRESETS), default="tiny")
    parser.add_argument("--model-dir", default="sp_models")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--gtp", default=None,
                        help="external GTP command for --b (overrides --b)")
    parser.add_argument("--sgf-dir", default=None,
                        help="write every duel game as SGF into this dir")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run on "
                        "the CPU)")
    args = parser.parse_args(argv)
    cfg = PRESETS[args.preset]()
    if args.gtp:
        res = duel_vs_gtp(args.a, args.gtp, cfg=cfg, model_dir=args.model_dir,
                          games=args.games, seed=args.seed, device=args.device)
    else:
        res = duel(args.a, args.b, cfg=cfg, model_dir=args.model_dir,
                   games=args.games, seed=args.seed, sgf_dir=args.sgf_dir,
                   michi_sims=args.michi_sims, max_moves=args.max_moves,
                   device=args.device)
    print(res)


if __name__ == "__main__":
    main()
