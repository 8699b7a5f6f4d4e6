"""Train the 19x19 preset end to end (port of scripts/train_19x19.py): the
reference's deployment shape (full_19x19: 20 blocks x 256 filters, 1600
simulations a move) with a reduced game count:

1. corpus: 19x19 games of the model-free heuristic engine
   (``search/rollout.py``'s predict function under the production
   search), saved as SGFs, merged with real 19x19 games when a caller of
   ``train`` names a directory of them (``reference_games``; off by
   default, and the command line names none);
2. KGS-pretrain the production net on that corpus
   (``Pipeline.kgs_pretrain_phase``) and make it best;
3. closed-loop generations (self-play -> train -> gate) with calibrated
   resignation live.

Every stage appends one event to <workdir>/train19.jsonl.

    python -m sejonggo_torch.tools.train_19x19 --workdir runs/full19_port \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Optional

import torch

from sejonggo_torch._device import resolve_device
from sejonggo_torch.config import Config

def make_config(selfplay_games: int, game_batch: int, eval_games: int,
                train_epochs: int, eval_max_moves=None) -> Config:
    from sejonggo_torch.config import (EvalConfig, SelfPlayConfig,
                                       TrainConfig, full_19x19)

    cfg = full_19x19()
    return cfg.replace(
        selfplay=SelfPlayConfig(
            num_games=selfplay_games, stop_exploration=30,
            resignation_percent=0.10, resignation_cap=-0.90,
            game_batch=game_batch),
        eval=EvalConfig(num_games=eval_games, margin=0.55,
                        max_moves=eval_max_moves),
        train=dataclasses.replace(TrainConfig(), epochs_per_save=train_epochs),
    )


def corpus_search(sims: int):
    """The corpus games' search: ``sims`` simulations in rounds of a
    quarter of them (at least 8), 3 * sims tree slots."""
    from sejonggo_torch.config import SearchConfig

    return SearchConfig(simulations=sims, batch_size=max(sims // 4, 8),
                        dirichlet_alpha=0.03, max_nodes=3 * sims)


def generate_corpus(outdir: str, *, games: int, game_batch: int,
                    sims: int, seed: int, device=None,
                    draws: Optional[Callable[[int], Callable]] = None) -> int:
    """Self-play the heuristic rollout engine at 19x19 and save SGFs
    (the locally generated half of the pretraining data).  The games'
    random draws come from a CPU generator seeded with ``seed``, or from
    ``draws(batch_index)``, which returns that batch's ``draws(move_n)``
    for ``play_games``."""
    from sejonggo_torch.actor import play_games
    from sejonggo_torch.learn.duel import save_gamebatch_sgfs
    from sejonggo_torch.search.rollout import make_heuristic_predict_fn

    dev = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    existing = [f for f in os.listdir(outdir) if f.endswith(".sgf")]
    if len(existing) >= games:
        print(f"corpus: {len(existing)} SGFs already present, skipping")
        return len(existing)
    predict = make_heuristic_predict_fn(7.5)
    search = corpus_search(sims)
    generator = torch.Generator().manual_seed(seed)
    done = 0
    batch_i = 0
    while done < games:
        b = min(game_batch, games - done)
        t0 = time.time()
        gb = play_games(predict, size=19, komi=7.5, search=search,
                        game_batch=b, generator=generator, selfplay=True,
                        stop_exploration=30, device=dev,
                        draws=None if draws is None else draws(batch_i))
        save_gamebatch_sgfs(gb, size=19, komi=7.5, outdir=outdir,
                            prefix=f"rollout_{batch_i:02d}",
                            a_name="rollout", b_name="rollout")
        done += b
        batch_i += 1
        print(f"corpus: {done}/{games} games "
              f"({time.time() - t0:.0f}s/batch, "
              f"mean_moves={float(gb.num_moves.mean()):.0f})", flush=True)
    return done


def train(cfg: Config, args: argparse.Namespace,
          reference_games: Optional[str] = None) -> list:
    """Corpus, pretraining and generations at ``cfg`` with the options of
    ``args`` (this module's flags, as ``parse_args`` returns them);
    returns the events written to train19.jsonl.  ``reference_games``
    names a directory of real 19x19 SGFs to link into the corpus before
    pretraining; None merges nothing."""
    from sejonggo_torch.pipeline import Pipeline
    from sejonggo_torch.utils.metrics import setup_logging

    dev = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    setup_logging(os.path.join(args.workdir, "logs"))
    events = []

    def emit(line):
        events.append(line)
        print(json.dumps(line), flush=True)
        with open(os.path.join(args.workdir, "train19.jsonl"), "a") as f:
            f.write(json.dumps(line) + "\n")

    # 1. corpus ---------------------------------------------------------
    corpus = os.path.join(args.workdir, "corpus")
    if not args.skip_corpus:
        t0 = time.time()
        n = generate_corpus(corpus, games=args.corpus_games,
                            game_batch=args.corpus_batch,
                            sims=args.corpus_sims, seed=args.seed + 7,
                            device=dev)
        emit({"event": "corpus", "games": n,
              "seconds": round(time.time() - t0, 1)})
    # merge in the named real 19x19 games (read-only): symlinks
    os.makedirs(corpus, exist_ok=True)
    if reference_games is not None:
        for f in os.listdir(reference_games):
            if f.endswith(".sgf"):
                dst = os.path.join(corpus, f)
                if not os.path.exists(dst):
                    os.symlink(os.path.join(os.path.abspath(reference_games),
                                            f), dst)

    # 2. pipeline: pretrain + closed loop -------------------------------
    pipe = Pipeline(cfg, args.workdir, seed=args.seed, device=dev)
    resumed = pipe.load_run_state()
    pipe.init_models()
    emit({"event": "start", "resumed": resumed,
          "best": pipe.store.best_name(),
          "latest": pipe.store.latest_name()})

    if not args.skip_pretrain and pipe.store.latest_name() == "model_1":
        t0 = time.time()
        stats = pipe.kgs_pretrain_phase(corpus, args.pretrain_steps,
                                        backup_every=200)
        emit({"event": "kgs_pretrain",
              **{k: v for k, v in stats.items()
                 if isinstance(v, (int, float, str))}})
        # the pretrained net becomes best so self-play uses it
        pipe.store.set_best(pipe.store.latest_name())
        emit({"event": "pretrain_promoted", "best": pipe.store.best_name(),
              "seconds": round(time.time() - t0, 1)})

    for gen in range(args.generations):
        t0 = time.time()
        r = pipe.run(generations=1)[0]
        sp, tr, ev = r["selfplay"], r["train"], r["evaluate"]
        emit({"event": "generation", "gen": gen,
              "seconds": round(time.time() - t0, 1),
              "games": sp["games"], "moves": sp["moves"],
              "env_steps_per_s": round(sp["env_steps_per_s"], 1),
              "resign_threshold": sp.get("resign_threshold"),
              "resigned_games": sp.get("resigned_games"),
              "winner_dip_rate": sp.get("winner_dip_rate"),
              "loss": round(tr.get("loss", float("nan")), 4),
              "gate_winrate": ev.get("winrate"),
              "promote": ev.get("promote"),
              "best": pipe.store.best_name()})

    emit({"event": "done", "best": pipe.store.best_name(),
          "latest": pipe.store.latest_name()})
    return events


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="runs/full19_r5")
    ap.add_argument("--corpus-games", type=int, default=48)
    ap.add_argument("--corpus-batch", type=int, default=24)
    ap.add_argument("--corpus-sims", type=int, default=48)
    ap.add_argument("--pretrain-steps", type=int, default=600)
    ap.add_argument("--generations", type=int, default=2)
    ap.add_argument("--games", type=int, default=8,
                    help="self-play games per generation")
    ap.add_argument("--game-batch", type=int, default=8)
    ap.add_argument("--eval-games", type=int, default=8)
    ap.add_argument("--eval-max-moves", type=int, default=0,
                    help="move cap for eval games (0 = engine default "
                    "2*N*N; capped games are decided by area score)")
    ap.add_argument("--train-epochs", type=int, default=8,
                    help="epochs_per_save for the closed-loop train phase "
                    "(reference 300 is a multi-day budget)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-corpus", action="store_true")
    ap.add_argument("--skip-pretrain", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run on the "
                    "CPU)")
    return ap.parse_args(argv)


def config_of(args: argparse.Namespace) -> Config:
    """``make_config`` of the flags, as the JAX script builds it."""
    return make_config(args.games, args.game_batch, args.eval_games,
                       args.train_epochs,
                       eval_max_moves=args.eval_max_moves or None)


def main(argv=None):
    args = parse_args(argv)
    return train(config_of(args), args)


if __name__ == "__main__":
    main()
