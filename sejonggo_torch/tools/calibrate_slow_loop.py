"""Calibration run of the slow closed-loop test's configuration (port of
scripts/calibrate_slow_loop.py): run that configuration for N
generations and print each generation's gate win rate, loss and best
model, then the promotions, so a test's generation budget can be set
where promotion is reliable rather than marginal.  ``--end-duel N`` then
plays the final best against model_1 over N games.

The defaults are the JAX script's (one block of 16 filters, 4 epochs);
the slow-learning test's configuration (tests/test_slow_learning.py) is

    python -m sejonggo_torch.tools.calibrate_slow_loop --blocks 2 \
        --filters 24 --epochs 6 --gens 14 --seed 3 --end-duel 48

Unlike the JAX script, which forces the CPU, it runs on the card unless
``--device cpu`` is passed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time

import torch

from sejonggo_torch._device import resolve_device
from sejonggo_torch.config import Config


def make_config(blocks: int = 1, filters: int = 16, epochs: int = 4,
                lr: float = 2e-2, games: int = 32) -> Config:
    """The slow closed-loop test's configuration at the given net, train
    and game sizes (scripts/calibrate_slow_loop.py:50-66)."""
    from sejonggo_torch.config import (EvalConfig, GoConfig, NetConfig,
                                       SearchConfig, SelfPlayConfig,
                                       TrainConfig, small_9x9)

    return dataclasses.replace(
        small_9x9(),
        go=GoConfig(size=9, komi=5.5),
        net=NetConfig(blocks=blocks, filters=filters, value_hidden=filters,
                      compute_dtype="float32"),
        search=SearchConfig(simulations=32, batch_size=8,
                            use_symmetry=True, policy_target="visits",
                            negamax=True, dirichlet_alpha=0.25),
        selfplay=SelfPlayConfig(num_games=games, stop_exploration=8,
                                game_batch=16, resignation_percent=1.0),
        train=TrainConfig(batch_size=64, iters_per_epoch=64,
                          epochs_per_save=epochs, replay_window=6144,
                          lr=lr),
        eval=EvalConfig(num_games=16, margin=0.55),
    )


def calibrate(cfg: Config, *, gens: int, seed: int, end_duel: int = 0,
              device=None) -> dict:
    """``gens`` generations of ``Pipeline.run`` at ``cfg`` in a temporary
    workdir, printing one JSON line a
    generation, the promotions, and the end duel's line when asked;
    returns {"generations": [...], "promotions": [...], "end_duel": ...}."""
    from sejonggo_torch.config import EvalConfig
    from sejonggo_torch.learn import evaluate_models
    from sejonggo_torch.nets import make_predict_fn
    from sejonggo_torch.pipeline import Pipeline

    dev = resolve_device(device)
    out = {"generations": [], "promotions": [], "end_duel": None}
    with tempfile.TemporaryDirectory() as tmp:
        pipe = Pipeline(cfg, tmp, seed=seed, device=dev)
        for gen in range(gens):
            t0 = time.time()
            prev = pipe.store.best_name()
            r = pipe.run(generations=1)[0]
            best = pipe.store.best_name()
            if best != prev:
                out["promotions"].append((gen, best))
            line = {
                "gen": gen, "s": round(time.time() - t0, 1),
                "winrate": r["evaluate"].get("winrate"),
                "loss": round(r["train"].get("loss", float("nan")), 3),
                "best": best}
            out["generations"].append(line)
            print(json.dumps(line), flush=True)
        print(json.dumps({"promotions": out["promotions"]}), flush=True)
        if end_duel and pipe.store.best_name() != "model_1":
            bs = pipe.load(pipe.store.best_name())
            m1 = pipe.load("model_1")
            res = evaluate_models(
                make_predict_fn(bs.net), make_predict_fn(m1.net), size=9,
                komi=5.5, search=cfg.search,
                eval_cfg=EvalConfig(num_games=end_duel, margin=0.55),
                generator=torch.Generator().manual_seed(123),
                game_batch=16, device=dev)
            out["end_duel"] = res["winrate"]
            print(json.dumps({"end_duel": res["winrate"],
                              "best": pipe.store.best_name()}), flush=True)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gens", type=int, default=14)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--games", type=int, default=32)
    ap.add_argument("--blocks", type=int, default=1)
    ap.add_argument("--filters", type=int, default=16)
    ap.add_argument("--end-duel", type=int, default=0,
                    help="after the loop, duel best vs model_1 over N games")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run on the "
                    "CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = make_config(args.blocks, args.filters, args.epochs, args.lr,
                      args.games)
    return calibrate(cfg, gens=args.gens, seed=args.seed,
                     end_duel=args.end_duel, device=args.device)


if __name__ == "__main__":
    main()
