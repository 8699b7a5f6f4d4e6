"""Strength campaign: run the closed loop until the gated best model beats
the model-free heuristic engine, with ladder evidence (port of
scripts/strength_campaign.py).

It runs ``--preset strength`` (or ``xl``) generations of
``sejonggo_torch.pipeline.Pipeline`` on the card and
- tracks promotions; saves run state every generation (resumable);
- can seed an empty workdir from a committed checkpoint (``--seed-from``);
- probes the heuristic rung (a quick duel, ``--probe-games``) after every
  promotion and every ``--probe-every`` generations;
- with ``--michi-rung S`` also probes promotions against the michi/RAVE
  engine at S simulations; the rung doubles, up to 1400, after a 64-game
  confirm at >= 0.55;
- stops with success once a confirm duel (``--confirm-games``, SGFs under
  <workdir>/duels/) reaches ``--target-winrate``;
- also stops at ``--generations`` or ``--max-hours``.

Every event but ``campaign_start`` (printed only) is printed and appended
to <workdir>/campaign.jsonl.

    python -m sejonggo_torch.tools.strength_campaign --preset xl \
        --workdir runs/strength_port --seed-from \
        runs/strength_r5b/sp_models/model_291.msgpack [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import time

from sejonggo_torch._device import resolve_device
from sejonggo_torch.config import Config


def seed_workdir(model_dir: str, seed_from: str) -> None:
    """Seed an empty store with a committed checkpoint as best+latest
    (model-level-checkpoint restart, reference model.py:125-157)."""
    name = os.path.splitext(os.path.basename(seed_from))[0]
    os.makedirs(model_dir, exist_ok=True)
    shutil.copyfile(seed_from, os.path.join(model_dir, name + ".msgpack"))
    with open(os.path.join(model_dir, "index.json"), "w") as f:
        json.dump({"best": name}, f)


def campaign(cfg: Config, args: argparse.Namespace) -> dict:
    """The campaign at ``cfg`` with the options of ``args`` (this module's
    flags, as ``parse_args`` returns them); returns the
    ``campaign_done`` event."""
    from sejonggo_torch.learn.duel import duel
    from sejonggo_torch.pipeline import Pipeline
    from sejonggo_torch.utils.metrics import setup_logging

    dev = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    model_dir = os.path.join(args.workdir, cfg.model_dir)
    if args.seed_from and not (os.path.isdir(model_dir)
                               and any(f.endswith(".msgpack")
                                       for f in os.listdir(model_dir))):
        seed_workdir(model_dir, args.seed_from)
    setup_logging(os.path.join(args.workdir, cfg.log_dir))
    pipe = Pipeline(cfg, args.workdir, seed=args.seed, device=dev)
    resumed = pipe.load_run_state()
    pipe.init_models()
    start_best = pipe.store.best_name()
    print(json.dumps({"event": "campaign_start", "resumed": resumed,
                      "best": start_best,
                      "latest": pipe.store.latest_name()}), flush=True)

    def emit(line):
        print(json.dumps(line), flush=True)
        with open(os.path.join(args.workdir, "campaign.jsonl"), "a") as f:
            f.write(json.dumps(line) + "\n")

    def heuristic_duel(model, games, sgf_dir=None):
        t0 = time.time()
        res = duel(model, "heuristic", cfg=cfg, model_dir=model_dir,
                   games=games, sgf_dir=sgf_dir, device=dev)
        emit({"event": "heuristic_probe", "model": model,
              "games": games, "winrate": res["winrate"],
              "elo": round(res["elo_diff_a_vs_b"], 1),
              "seconds": round(time.time() - t0, 1)})
        return res["winrate"]

    def michi_duel(model, games, sims, sgf_dir=None):
        t0 = time.time()
        res = duel(model, "michi", cfg=cfg, model_dir=model_dir,
                   games=games, michi_sims=sims, sgf_dir=sgf_dir,
                   max_moves=130, device=dev)
        emit({"event": "michi_probe", "model": model, "michi_sims": sims,
              "games": games, "winrate": res["winrate"],
              "michi_resigns": res["michi_resigns"],
              "elo": round(res["elo_diff_a_vs_b"], 1),
              "seconds": round(time.time() - t0, 1)})
        return res["winrate"]

    t_start = time.time()
    promotions = []
    last_probed = None
    michi_rung = args.michi_rung
    done = False
    for gen in range(args.generations):
        t0 = time.time()
        prev_best = pipe.store.best_name()
        r = pipe.run(generations=1)[0]
        best = pipe.store.best_name()
        if best != prev_best:
            promotions.append(best)
        line = {
            "event": "generation", "gen": gen, "seconds":
            round(time.time() - t0, 1),
            "games": r["selfplay"]["games"],
            "moves": r["selfplay"]["moves"],
            "env_steps_per_s": round(r["selfplay"]["env_steps_per_s"], 1),
            "loss": round(r["train"].get("loss", float("nan")), 4),
            "policy_ce": round(r["train"].get("policy_ce", float("nan")), 4),
            "value_mse": round(r["train"].get("value_mse", float("nan")), 4),
            "lr": pipe.lr,
            "winrate": r["evaluate"].get("winrate"),
            "best": best, "promotions": len(promotions),
        }
        # calibrated-resignation telemetry: the <=5% winner-resign
        # property, live
        sp = r["selfplay"]
        if sp.get("resign_threshold") is not None or sp.get("resigned_games"):
            line["resign_threshold"] = sp.get("resign_threshold")
            line["resigned_games"] = sp.get("resigned_games")
            line["winner_dip_rate"] = round(sp.get("winner_dip_rate", 0.0), 4)
        emit(line)

        probe_due = (best != last_probed
                     and (best != prev_best
                          or (args.probe_every
                              and (gen + 1) % args.probe_every == 0)))
        if probe_due:
            last_probed = best
            if michi_rung:
                mwr = michi_duel(best, args.michi_probe_games, michi_rung)
                if mwr >= 0.55:
                    cwr = michi_duel(
                        best, 64, michi_rung,
                        sgf_dir=os.path.join(args.workdir, "duels",
                                             f"{best}_vs_michi{michi_rung}"))
                    if cwr >= 0.55:
                        emit({"event": "michi_rung_confirmed",
                              "model": best, "michi_sims": michi_rung,
                              "winrate": cwr})
                        michi_rung = min(michi_rung * 2, 1400) \
                            if michi_rung < 1400 else michi_rung
            wr = heuristic_duel(best, args.probe_games)
            if wr >= args.target_winrate:
                wr2 = heuristic_duel(
                    best, args.confirm_games,
                    sgf_dir=os.path.join(args.workdir, "duels",
                                         f"{best}_vs_heuristic"))
                if wr2 >= args.target_winrate:
                    emit({"event": "target_reached", "model": best,
                          "winrate": wr2})
                    done = True
                    break
        if args.max_hours and time.time() - t_start > args.max_hours * 3600:
            emit({"event": "wallclock_stop", "gen": gen})
            break

    end = {"event": "campaign_done", "reached_target": done,
           "promotions": promotions, "best": pipe.store.best_name(),
           "latest": pipe.store.latest_name(),
           "hours": round((time.time() - t_start) / 3600, 2)}
    emit(end)
    return end


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="runs/strength_r4")
    ap.add_argument("--generations", type=int, default=400)
    ap.add_argument("--seed-from", default=None,
                    help="checkpoint .msgpack to seed an empty workdir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--probe-games", type=int, default=32)
    ap.add_argument("--confirm-games", type=int, default=64)
    ap.add_argument("--probe-every", type=int, default=16,
                    help="probe cadence in generations (also probes on "
                    "every promotion)")
    ap.add_argument("--target-winrate", type=float, default=0.5)
    ap.add_argument("--max-hours", type=float, default=0.0)
    ap.add_argument("--preset", choices=["strength", "xl"],
                    default="strength",
                    help="xl = strength_9x9_xl: 192 sims/move, calibrated "
                    "resignation live")
    ap.add_argument("--michi-rung", type=int, default=0,
                    help="also probe promotions vs the michi/RAVE engine "
                    "at this sims budget (learn/duel_michi); the rung "
                    "doubles after each confirmed >=0.55 win, climbing "
                    "toward the reference budget 1400")
    ap.add_argument("--michi-probe-games", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run on the "
                    "CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    from sejonggo_torch import config

    args = parse_args(argv)
    cfg = (config.strength_9x9() if args.preset == "strength"
           else config.strength_9x9_xl())
    return campaign(cfg, args)


if __name__ == "__main__":
    main()
