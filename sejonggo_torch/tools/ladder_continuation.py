"""Ladder rungs for a continuation strength run (port of
scripts/ladder_continuation.py): a workdir seeded from a prior run's best
checkpoint has no model_1 or mid-run rung, so the new best duels the
seed checkpoint and the heuristic engine, appending to
<workdir>/strength.jsonl with SGFs under <workdir>/duels/ — the evidence
format of ``sejonggo_torch.tools.strength_report``.

    python -m sejonggo_torch.tools.ladder_continuation \
        --workdir runs/strength_r3b --seed-model model_39 [--games 64] \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

from sejonggo_torch._device import resolve_device
from sejonggo_torch.config import Config
from sejonggo_torch.tools.strength_report import preset_config


def continue_ladder(cfg: Config, args: argparse.Namespace) -> list:
    """The continuation rungs of ``args.workdir``'s store at ``cfg``;
    returns the logged events."""
    from sejonggo_torch.learn import CheckpointStore
    from sejonggo_torch.learn.duel import duel
    from sejonggo_torch.utils.metrics import MetricsLogger

    dev = resolve_device(args.device)
    model_dir = os.path.join(args.workdir, cfg.model_dir)
    store = CheckpointStore(model_dir)
    best = store.best_name()
    if not best:
        raise FileNotFoundError(f"no best checkpoint under {model_dir}")
    metrics = MetricsLogger(os.path.join(args.workdir, "strength.jsonl"))
    sgf_root = os.path.join(args.workdir, "duels")

    for b in [args.seed_model, "heuristic"]:
        if best == b:
            continue
        t0 = time.time()
        res = duel(best, b, cfg=cfg, model_dir=model_dir, games=args.games,
                   sgf_dir=os.path.join(sgf_root, f"{best}_vs_{b}"),
                   device=dev)
        res["seconds"] = round(time.time() - t0, 1)
        print(json.dumps(res), flush=True)
        metrics.log("duel", **res)
    return metrics.events


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="runs/strength_r3b")
    ap.add_argument("--seed-model", default="model_39")
    ap.add_argument("--games", type=int, default=64)
    ap.add_argument("--preset", default="strength",
                    choices=["tiny", "strength", "full"])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run on the "
                    "CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    return continue_ladder(preset_config(args.preset), args)


if __name__ == "__main__":
    main()
