"""Strength-ladder evidence for a finished strength run (port of
scripts/strength_report.py).  The promoted best model duels

  1. model_1 (the untrained starting point),
  2. the mid-run best (model_<latest // 2>),
  3. the model-free heuristic rollout engine,
  4. (optionally) an external GTP engine (GNU Go when installed).

Win rates and Elo differences are appended to <workdir>/strength.jsonl
and every game is written as SGF under <workdir>/duels/.

    python -m sejonggo_torch.tools.strength_report --workdir runs/strength_r2 \
        [--games 64] [--gtp "gnugo --mode gtp --level 1"] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

from sejonggo_torch._device import resolve_device
from sejonggo_torch.config import Config


def report(cfg: Config, args: argparse.Namespace) -> list:
    """The ladder of ``args.workdir``'s store at ``cfg``; returns the
    logged events."""
    from sejonggo_torch.learn import CheckpointStore
    from sejonggo_torch.learn.duel import duel, duel_vs_gtp
    from sejonggo_torch.utils.metrics import MetricsLogger

    dev = resolve_device(args.device)
    model_dir = os.path.join(args.workdir, cfg.model_dir)
    store = CheckpointStore(model_dir)
    best = store.best_name()
    latest = store.latest_name()
    if not (best and latest):
        raise FileNotFoundError(f"no checkpoints under {model_dir}")
    mid = f"model_{max(int(latest.split('_')[1]) // 2, 1)}"
    metrics = MetricsLogger(os.path.join(args.workdir, "strength.jsonl"))
    sgf_root = os.path.join(args.workdir, "duels")

    ladder = [(best, "model_1"), (best, mid), (best, "heuristic")]
    for a, b in ladder:
        if a == b:
            continue
        t0 = time.time()
        res = duel(a, b, cfg=cfg, model_dir=model_dir, games=args.games,
                   sgf_dir=os.path.join(sgf_root, f"{a}_vs_{b}"), device=dev)
        res["seconds"] = round(time.time() - t0, 1)
        print(json.dumps(res))
        metrics.log("duel", **res)

    if args.gtp:
        t0 = time.time()
        res = duel_vs_gtp(best, args.gtp, cfg=cfg, model_dir=model_dir,
                          games=min(args.games, 10), device=dev)
        res.update(a=best, b=f"gtp:{args.gtp}",
                   seconds=round(time.time() - t0, 1))
        print(json.dumps(res))
        metrics.log("duel_gtp", **res)
    return metrics.events


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="runs/strength_r2")
    ap.add_argument("--games", type=int, default=64)
    ap.add_argument("--gtp", default=None,
                    help="external GTP command (e.g. 'gnugo --mode gtp')")
    ap.add_argument("--preset", default="strength",
                    choices=["tiny", "strength", "full"])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run on the "
                    "CPU)")
    return ap.parse_args(argv)


def preset_config(name: str) -> Config:
    """The config of a ``--preset`` name, read from the config module at
    call time."""
    from sejonggo_torch import config

    return {"tiny": config.small_9x9, "strength": config.strength_9x9,
            "full": config.full_19x19}[name]()


def main(argv=None):
    args = parse_args(argv)
    return report(preset_config(args.preset), args)


if __name__ == "__main__":
    main()
