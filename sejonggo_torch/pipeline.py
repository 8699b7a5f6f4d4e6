"""Closed actor-learner loop: self-play -> train -> evaluate -> gate (port
of sejonggo_tpu/pipeline.py).

Reference counterpart: pipeline_sequent.py / main.py:13-28 — the
sequential loop of (self-play with best model) -> (train latest) ->
(evaluate latest vs best) -> (promote on >55% winrate), with "best" and
"latest" as the only global state, carried by the CheckpointStore.

Every phase loads its nets from the store: self-play plays the best
model, training updates a fresh net loaded from the latest, the gate
plays latest against best, so play nets (eval mode) and the train net
are separate modules.  Where the JAX loop splits a ``jax.random`` key, the
port draws from one CPU ``torch.Generator`` seeded from ``seed``; its
state is part of the run state.  The KGS pretraining phase replays SGF
games on the pipeline's device; self-play games can be archived as SGF
and/or the reference's HDF5 samples.

Several cards: one process per card, each a rank of a
``torch.distributed`` group (``sejonggo_torch/parallel``), all sharing
the workdir, as the JAX package runs one process per host:

    python -m sejonggo_torch.pipeline --preset tiny --device cpu
    python -m sejonggo_torch.pipeline --preset strength \
        --coordinator host0:29500 --num-hosts 2 --host-id {0,1}
    # two machines of 4 cards: rank 4h+i on card i of machine h
    python -m sejonggo_torch.pipeline --preset strength \
        --coordinator host0:29500 --num-hosts 8 --host-id 4h+i --local-rank i
    torchrun --nproc-per-node 4 -m sejonggo_torch.pipeline --preset strength
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import re
import shutil
import time
from typing import Optional

import numpy as np
import torch

from sejonggo_torch.actor import ContinuousSelfPlay, ResignCalibrator
from sejonggo_torch.config import (Config, full_19x19, small_9x9,
                                   strength_9x9)
from sejonggo_torch.learn import (CheckpointStore, PlateauScheduler,
                                  ReplayBuffer, evaluate_models, game_samples,
                                  init_train_state, load_segment,
                                  make_optimizer, make_train_step,
                                  save_segment)
from sejonggo_torch.nets import (AZNet, from_jax_variables, init_variables,
                                 make_predict_fn)
from sejonggo_torch.parallel import (host_local_batch, init_distributed,
                                     make_mesh, process_count, process_index,
                                     rank_device, rank_seed)
from sejonggo_torch.utils.metrics import MetricsLogger

logger = logging.getLogger("sejonggo_torch.pipeline")


class Pipeline:
    """Actor-learner loop over the ranks of a process group, one card
    each (``device``: the rank's card unless the caller names another).

    Parallel layout (the JAX package's, with one device per host; it
    replaces the reference's 3 self-play servers + 1 training server over
    BaseManager RPC + scp, conf.py:57-82, master_coordinator.py:120-157):
    one ``mesh`` of every rank (``cfg.dist.dp``, or the ``mesh`` passed
    in, which the JAX package also uses for both its meshes).  Each rank
    plays its ``mesh.game_slice`` of the self-play and gate games on its
    card with its own generator and harvests into its own replay window:
    the JAX package's per-host actor mesh holds one device here, so the
    actors run unsharded.  The global train batch is split evenly; each
    rank samples its share from its own replay, and the step all-reduces
    gradients and BatchNorm statistics (``learn/train.py``), so the
    parameters stay replicated.

    Rank 0 writes every checkpoint and the best pointer while the others
    wait at a barrier; the gate's counts are summed over the ranks, so
    every rank takes the same promotion decision.  One process: the mesh
    holds the one rank and every collective is a no-op."""

    def __init__(self, cfg: Config, workdir: str = ".", seed: int = 0,
                 device=None, mesh=None):
        self.cfg = cfg
        self.workdir = workdir
        self.device = rank_device(device)
        self.store = CheckpointStore(os.path.join(workdir, cfg.model_dir))
        self.lr = cfg.train.lr
        self.tx = make_optimizer(self.lr, cfg.train.momentum, cfg.net.l2)
        # ReduceLROnPlateau (reference main_training.py:72); None = off
        self.plateau = None
        if cfg.train.lr_plateau_factor:
            self.plateau = PlateauScheduler(
                self.lr, factor=cfg.train.lr_plateau_factor,
                patience=cfg.train.lr_plateau_patience,
                min_lr=cfg.train.lr_min)
        self.mesh = mesh if mesh is not None else make_mesh(
            cfg.dist.dp, cfg.dist.mesh_axis_name, device=self.device)
        self.train_step = make_train_step(self.tx, cfg.train.loss_mode,
                                          mesh=self.mesh)
        # each rank draws from its own stream (the port's form of
        # jax.random.fold_in(key, process_index)); one process: ``seed``
        self.generator = torch.Generator().manual_seed(rank_seed(seed))
        self.replay = ReplayBuffer(cfg.train.replay_window, cfg.go.size,
                                   seed=seed)
        self.calibrator = ResignCalibrator(
            cfg.selfplay.resignation_percent,
            cfg.selfplay.resignation_allowed_error, seed=seed,
            cap=cfg.selfplay.resignation_cap)
        self.metrics = MetricsLogger(os.path.join(workdir, "metrics.jsonl"))
        # reference NoModelEvaluateWorker reuses eval games as training
        # data (evaluate_worker.py:151)
        self.eval_games_to_replay = True
        # reference always archives self-play games (sgfsave.py:49-79);
        # here opt-in: the replay buffer is the primary store
        self.archive_selfplay = False
        # 'sgf', 'h5' (reference game_%05d/move_%03d/sample.h5 layout),
        # or 'both'
        self.archive_format = "sgf"
        self._archive_counts = {}  # per-model archived-game counters
        # split-role selfplay->train data path (reference scp push per
        # game, selfplay_worker.py:123-124): selfplay role publishes one
        # replay segment per phase here; train role ingests new ones
        self.segment_dir = os.path.join(workdir, "replay_segments")
        self._segment_games = None     # per-phase accumulator (selfplay role)
        self._segment_seq = None       # next segment index (lazy-scanned)
        self._ingested_segments = set()  # consumed files (train role)

    def set_lr(self, lr: float) -> None:
        """Change the learning rate: a new optimiser and train step.  The
        momentum trace lives in the train state and is kept, so
        checkpointed optimizer state stays loadable."""
        self.lr = lr
        self.tx = make_optimizer(lr, self.cfg.train.momentum,
                                 self.cfg.net.l2)
        self.train_step = make_train_step(self.tx, self.cfg.train.loss_mode,
                                          mesh=self.mesh)
        logger.info("learning rate set to %g", lr)

    def _put_train_batch(self, arr: np.ndarray) -> torch.Tensor:
        """This rank's rows of the global train batch on its device,
        checked to be its even share."""
        return host_local_batch(torch.from_numpy(arr).to(self.device),
                                self.mesh, self.cfg.train.batch_size)

    @property
    def _local_train_batch_size(self) -> int:
        n = self.mesh.size
        bs = self.cfg.train.batch_size
        if bs % n:
            raise ValueError(f"train batch {bs} not divisible by {n} ranks")
        return bs // n

    # --- model lifecycle (reference model.py:98-157) --------------------

    def _net(self) -> AZNet:
        return AZNet.from_config(self.cfg.go.size, self.cfg.net).to(self.device)

    def init_models(self):
        """Create model_1 as best+latest if the store is empty
        (reference create_initial_model model.py:98-122)."""
        empty = self.store.latest_name() is None
        # every rank has looked at the store before rank 0 writes to it
        self.mesh.barrier()
        if empty:
            net = self._net()
            net.load_state_dict(from_jax_variables(init_variables(
                self.cfg.go.size, self.cfg.net, self.generator)))
            self._save_state_global("model_1", init_train_state(net),
                                    best=True)
            logger.info("created initial model_1 (best)")

    def _save_state_global(self, name: str, state, best: bool = False):
        """Checkpoint once per world: rank 0 writes (and points ``best``
        at it when asked; the shared workdir replaces the reference's scp
        model shipping, scpy.py:47-55), every rank waits at a barrier."""
        if process_index() == 0:
            self.store.save_state(name, state)
            if best:
                self.store.set_best(name)
        self.mesh.barrier()

    def _save_exit_backup(self, state, phase: str) -> None:
        """Rank 0 keeps its in-flight state as 'exit_backup' when its
        phase fails; no barrier: the other ranks may be inside a
        collective of another size, and the launcher or torchrun ends the
        world when this rank's error propagates."""
        if process_index() == 0:
            self.store.save_state("exit_backup", state)
            logger.exception("%s aborted; state saved as 'exit_backup'",
                             phase)
        else:
            logger.exception("%s aborted", phase)

    def load(self, name: str):
        # fallback: a dangling/torn checkpoint degrades to the newest
        # loadable model with a loud warning (learn/checkpoint.py)
        return self.store.load_state_or_fallback(name, self._net())

    # --- phases ---------------------------------------------------------

    def selfplay_phase(self, num_games: int = 0) -> dict:
        """Generate games with the BEST model (reference
        main_selfplay.py / model_self_play self_play.py:293-340) using
        the continuous respawning actor: every slot stays live instead of
        draining a lockstep batch."""
        cfg = self.cfg
        best = self.store.best_name()
        state = self.load(best)
        n = num_games or cfg.selfplay.num_games
        # several ranks: each plays its share of the games on its card
        n = len(self.mesh.game_slice(n))
        t0 = time.time()
        actor = ContinuousSelfPlay(
            make_predict_fn(state.net), size=cfg.go.size, komi=cfg.go.komi,
            search=cfg.search, game_batch=cfg.selfplay.game_batch,
            stop_exploration=cfg.selfplay.stop_exploration,
            generator=self.generator,
            threshold_fn=self.calibrator.threshold_for_new_game,
            device=self.device)

        moves = 0
        # archive game index continues across phases of the same model
        # (the reference numbers game dirs monotonically per model dir)
        archived = self._archive_counts.get(best, 0)
        resigned_games = 0
        holdout_games = 0
        holdout_winner_dips = 0
        games_done = 0
        log_every = max(1, n // 16)

        def on_game(game):
            nonlocal moves, archived, resigned_games, holdout_games
            nonlocal holdout_winner_dips, games_done
            # online check of the calibration property (reference
            # ALLOWED_ERROR=5%, self_play.py:319-330): on each HOLDOUT
            # game (played to the end), did the eventual winner's value
            # ever dip below the CURRENT threshold (i.e. would the
            # winner have resigned)?  Target: dip rate <= allowed_error.
            thr = self.calibrator.current
            if game.get("holdout", True):
                holdout_games += 1
                w = int(game["winner"])
                if thr is not None and w != 0:
                    mask = np.asarray(game["players"]) == w
                    if mask.any() and float(
                            np.asarray(game["values"])[mask].min()) <= thr:
                        holdout_winner_dips += 1
            elif game.get("resigned"):
                resigned_games += 1
            self.calibrator.observe_game(game)
            moves += self.replay.add_game(game)
            if self._segment_games is not None:
                self._segment_games.append(game_samples(game))
            if self.archive_selfplay:
                self._archive_game(game, best, archived)
                archived += 1
            games_done += 1
            if games_done % log_every == 0 or games_done == n:
                logger.info(
                    "selfplay progress: %d/%d games, %d moves, %.0fs",
                    games_done, n, moves, time.time() - t0)

        actor.run(n, on_game=on_game)
        self._archive_counts[best] = archived
        if self.archive_selfplay:
            # reference sweeps empty/short games and prunes beyond the
            # replay window after each self-play pass
            self.clean_archives()
        dt = time.time() - t0
        sims = moves * cfg.search.simulations
        stats = {
            "model": best, "games": actor.games_finished,
            "empty_games": actor.empty_games,
            "moves": moves, "seconds": dt,
            "moves_per_s": moves / max(dt, 1e-9),
            "env_steps_per_s": sims / max(dt, 1e-9),
            "sims_per_s": sims / max(dt, 1e-9),
            "tree_fresh_rate": actor.tree_fresh_rate,
            "resign_threshold": self.calibrator.current,
            "resigned_games": resigned_games,
            "holdout_games": holdout_games,
            "holdout_winner_dips": holdout_winner_dips,
            "winner_dip_rate": (holdout_winner_dips / holdout_games
                                if holdout_games else 0.0),
        }
        logger.info("selfplay: %s", stats)
        return dict(self.metrics.log("selfplay", phase="selfplay", **stats))

    def _archive_game(self, game: dict, model_name: str, game_n: int) -> None:
        """Reference-compatible archival of one finished game: SGF with
        per-move value comments (sgfsave.py:130-167 layout) and/or the
        reference's per-move HDF5 training-sample tree
        game_%05d/move_%03d/sample.h5 (sgfsave.py:49-79), so reference
        tooling can consume this build's games."""
        from sejonggo_torch.io.sgf import divmod_xy, game_to_sgf

        size = self.cfg.go.size
        if self.archive_format in ("h5", "both"):
            from sejonggo_torch.io.h5data import save_move_sample

            boards, policies, values = game_samples(game)
            base = os.path.join(self.workdir, self.cfg.selfplay_dir,
                                model_name, f"game_{game_n:05d}")
            for m in range(boards.shape[0]):
                save_move_sample(os.path.join(base, f"move_{m:03d}"),
                                 boards[m], policies[m], values[m])
        if self.archive_format not in ("sgf", "both"):
            return
        moves = [(int(p), *divmod_xy(int(a), size))
                 for p, a in zip(game["players"], game["actions"])]
        w = int(game["resign_winner"])
        if w == 0:
            result = "0"
        elif game["resigned"]:
            result = ("B" if w == 1 else "W") + "+R"
        else:
            margin = abs(game["black_points"] - game["white_points"])
            result = ("B" if w == 1 else "W") + f"+{margin}"
        d = os.path.join(self.workdir, self.cfg.selfplay_dir, model_name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"game_{game_n:05d}.sgf"), "w") as f:
            f.write(game_to_sgf(size, self.cfg.go.komi, moves, result,
                                values=list(map(float, game["values"]))))

    # --- archive maintenance (reference sgfsave.py:83-128 cleanup +
    # statistics, data_generator.py:36-40 window pruning,
    # utils.py:147-160 empty-dir sweep) --------------------------------

    def clean_archives(self, min_moves: int = 2) -> dict:
        """Sweep degenerate archived games and prune the archive to the
        replay window.

        - h5 game dirs with fewer than `min_moves` move dirs, and empty
          dirs, are deleted (reference clean_up_empty utils.py:147-160,
          sgfsave.py:83-96; zero-move game removal
          selfplay_worker.py:115-118);
        - the oldest archived games beyond cfg.train.replay_window are
          deleted, walking model generations oldest-first (reference
          clean_unused_self_play_data data_generator.py:36-40 via the
          N_MOST_RECENT_GAMES window of get_training_desc).
        Returns sweep statistics (the reference's statistics(),
        sgfsave.py:98-128, folded in as counts).
        """
        base = os.path.join(self.workdir, self.cfg.selfplay_dir)
        stats = {"models": 0, "games": 0, "moves": 0,
                 "swept_short": 0, "pruned_window": 0}
        if not os.path.isdir(base):
            return stats

        def model_key(name):
            m = re.search(r"(\d+)$", name)
            return int(m.group(1)) if m else -1

        models = sorted((d for d in os.listdir(base)
                         if os.path.isdir(os.path.join(base, d))),
                        key=model_key)
        per_game = []  # (model_idx, path, moves) oldest first
        for mi, model in enumerate(models):
            mdir = os.path.join(base, model)
            for entry in sorted(os.listdir(mdir)):
                path = os.path.join(mdir, entry)
                if entry.endswith(".sgf"):
                    with open(path, errors="replace") as f:
                        n_moves = f.read().count(";") - 1
                    if n_moves < min_moves:
                        os.remove(path)
                        stats["swept_short"] += 1
                        continue
                    per_game.append((mi, path, n_moves))
                elif os.path.isdir(path) and entry.startswith("game_"):
                    n_moves = sum(1 for p in os.listdir(path)
                                  if p.startswith("move_"))
                    if n_moves < min_moves:
                        shutil.rmtree(path)
                        stats["swept_short"] += 1
                        continue
                    per_game.append((mi, path, n_moves))
        total_moves = sum(m for _, _, m in per_game)
        # prune oldest games until the archived MOVE count fits the
        # replay window (the window is a sample count, learn/replay.py)
        window = self.cfg.train.replay_window
        i = 0
        while total_moves > window and i < len(per_game):
            _, path, m = per_game[i]
            (shutil.rmtree if os.path.isdir(path) else os.remove)(path)
            total_moves -= m
            stats["pruned_window"] += 1
            i += 1
        kept = per_game[i:]
        stats["games"] = len(kept)
        stats["moves"] = total_moves
        # drop model dirs emptied by the sweep
        for model in models:
            mdir = os.path.join(base, model)
            if os.path.isdir(mdir) and not os.listdir(mdir):
                os.rmdir(mdir)
            elif os.path.isdir(mdir):
                stats["models"] += 1
        logger.info("archive sweep: %s", stats)
        return stats

    # --- split-role selfplay->train data path (reference pushes every
    # finished game to the training server over scp as it completes,
    # selfplay_worker.py:123-124, scpy.py:68-107; here the selfplay role
    # publishes one atomic replay segment per phase and the train role
    # ingests new ones each iteration over the shared workdir) ----------

    def _publish_segment(self) -> Optional[str]:
        """Write the games accumulated this phase as one atomic replay
        segment under `segment_dir`; returns the path (None if no
        moves were produced)."""
        games = [g for g in (self._segment_games or []) if g[0].shape[0]]
        self._segment_games = []
        if not games:
            return None
        os.makedirs(self.segment_dir, exist_ok=True)
        prefix = f"seg_p{process_index()}_"
        if self._segment_seq is None:
            existing = [int(f[len(prefix):-4])
                        for f in os.listdir(self.segment_dir)
                        if f.startswith(prefix) and f.endswith(".npz")]
            self._segment_seq = max(existing, default=-1) + 1
        path = os.path.join(self.segment_dir,
                            f"{prefix}{self._segment_seq:06d}.npz")
        self._segment_seq += 1
        save_segment(path,
                     np.concatenate([g[0] for g in games]),
                     np.concatenate([g[1] for g in games]),
                     np.concatenate([g[2] for g in games]))
        return path

    def ingest_segments(self) -> int:
        """Train-role ingestion: load every replay segment not yet
        consumed into the replay window; returns moves added.  Segments
        are written atomically (tmp + os.replace) so a concurrent read
        never sees a torn file."""
        if not os.path.isdir(self.segment_dir):
            return 0
        added = 0
        for fname in sorted(os.listdir(self.segment_dir)):
            if not fname.endswith(".npz") or fname in self._ingested_segments:
                continue
            boards, policies, values = load_segment(
                os.path.join(self.segment_dir, fname))
            added += self.replay.add_samples(boards, policies, values)
            self._ingested_segments.add(fname)
        return added

    def train_phase(self) -> dict:
        """Train the latest model on the replay window and save
        model_<N+1> (reference train.py:24-72, TrainWorker)."""
        cfg = self.cfg
        latest = self.store.latest_name()
        state = self.load(latest)
        # named before the first step: no rank can see rank 0's new file
        name = self.store.next_name()
        steps = cfg.train.epochs_per_save * cfg.train.iters_per_epoch
        local_bs = self._local_train_batch_size
        t0 = time.time()
        # per-step loss curves, downsampled (reference streams per-step
        # TB scalars via the fake-epoch trick, train.py:63-70)
        log_every = max(1, steps // 32)
        curve_keys = ("loss", "policy_ce", "value_mse", "grad_norm")
        sums, n_logged = {}, 0
        skipped = consecutive_bad = 0
        try:
            for i in range(steps):
                boards, policies, values = self.replay.sample(local_bs)
                state, metrics = self.train_step(
                    state, self._put_train_batch(boards),
                    self._put_train_batch(policies),
                    self._put_train_batch(values))
                if (i + 1) % log_every == 0 or i + 1 == steps:
                    m = {k: float(v) for k, v in metrics.items()}
                    self.metrics.log("train_step", phase="train",
                                     model=latest, step=i + 1, lr=self.lr,
                                     **m)
                    # nonfinite batches skip their update inside the step
                    # (learn/train.py guard); count the whole logged
                    # window as bad so K consecutive windows abort
                    if m.get("nonfinite"):
                        skipped += 1
                        consecutive_bad += 1
                        limit = cfg.train.max_consecutive_nonfinite
                        if consecutive_bad >= max(limit // log_every, 2):
                            raise FloatingPointError(
                                f"{consecutive_bad} consecutive non-finite "
                                f"training windows (step {i + 1})")
                    else:
                        consecutive_bad = 0
                        for k in curve_keys:
                            if k in m:
                                sums[k] = sums.get(k, 0.0) + m[k]
                        n_logged += 1
        except BaseException:
            # crash-save (reference atexit exit_backup.h5 save,
            # main_training.py:22-25,101): keep the in-flight state
            self._save_exit_backup(state, "train phase")
            raise
        self._save_state_global(name, state)
        dt = time.time() - t0
        means = {k: v / max(n_logged, 1) for k, v in sums.items()}
        stats = {
            "from": latest, "to": name, "steps": steps,
            "seconds": dt, "steps_per_s": steps / max(dt, 1e-9),
            "samples_per_s": steps * cfg.train.batch_size / max(dt, 1e-9),
            "lr": self.lr, "nonfinite_windows": skipped,
            **means,
        }
        logger.info("train: %s", stats)
        stats = dict(self.metrics.log("train", phase="train", **stats))
        if self.plateau is not None and "loss" in means:
            new_lr = self.plateau.update(means["loss"])
            if new_lr is not None:
                self.set_lr(new_lr)
        return stats

    def kgs_pretrain_phase(self, data_dir: str, steps: int,
                           backup_every: int = 0) -> dict:
        """Supervised pretraining from KGS SGFs (reference
        main_training.py:34-98 continuous trainer + KGSDataGenerator).
        Trains the latest model in place and saves model_<N+1>;
        `backup_every` steps writes a crash-recovery 'backup' checkpoint
        (reference EPOCHS_PER_BACKUP / save_backup_model).  The games are
        replayed on the pipeline's device, shuffled by
        ``RandomState(rank)`` as the JAX package's processes do; each
        rank trains on its share of the batch."""
        from sejonggo_torch.io.kgs import kgs_sample_stream

        cfg = self.cfg
        latest = self.store.latest_name()
        state = self.load(latest)
        name = self.store.next_name()
        stream = kgs_sample_stream(
            data_dir, cfg.go.size, batch_size=self._local_train_batch_size,
            rng=np.random.RandomState(process_index()), loop=True,
            device=self.device)
        t0 = time.time()
        last_metrics = {}
        done_steps = 0
        try:
            for boards, policies, values in stream:
                state, metrics = self.train_step(
                    state, self._put_train_batch(boards),
                    self._put_train_batch(policies),
                    self._put_train_batch(values))
                last_metrics = metrics
                done_steps += 1
                if backup_every and done_steps % backup_every == 0:
                    self._save_state_global("backup", state)
                if done_steps >= steps:
                    break
        except BaseException:
            # reference atexit crash-save (main_training.py:22-25,101)
            self._save_exit_backup(state, "kgs pretrain")
            raise
        self._save_state_global(name, state)
        dt = time.time() - t0
        stats = {
            "from": latest, "to": name,
            "steps": done_steps, "seconds": dt,
            **{k: float(v) for k, v in last_metrics.items()},
        }
        logger.info("kgs_pretrain: %s", stats)
        return dict(self.metrics.log("kgs_pretrain", phase="kgs_pretrain",
                                     **stats))

    def evaluate_phase(self) -> dict:
        """Latest vs best gating (reference evaluator.py:23-47).

        Several ranks: each plays its share of the match on its card; the
        win, game and draw counts are summed over the ranks, so every
        rank takes the same promotion decision."""
        cfg = self.cfg
        latest = self.store.latest_name()
        best = self.store.best_name()
        if latest == best:
            return {"phase": "evaluate", "skipped": True}
        predict_latest = make_predict_fn(self.load(latest).net)
        predict_best = make_predict_fn(self.load(best).net)
        n_games = len(self.mesh.game_slice(cfg.eval.num_games))
        res = evaluate_models(
            predict_latest, predict_best,
            size=cfg.go.size, komi=cfg.go.komi, search=cfg.search,
            eval_cfg=dataclasses.replace(cfg.eval, num_games=n_games),
            generator=self.generator,
            game_batch=min(n_games, cfg.selfplay.game_batch),
            max_moves=cfg.eval.max_moves,
            collect_games=self.eval_games_to_replay, device=self.device)
        if self.mesh.size > 1:
            wins, played, draws = self.mesh.sum_counts(
                [res["wins"], res["games"], res["draws"]])
            res.update(wins=int(wins), games=int(played), draws=int(draws),
                       winrate=wins / played,
                       promote=wins / played > cfg.eval.margin)
        eval_moves = 0
        for gb in res.pop("game_batches", []):
            # reference NoModelEvaluateWorker saves evaluation games as
            # training data (evaluate_worker.py:151)
            eval_moves += self.replay.add_game_batch(gb)
        res["eval_moves_to_replay"] = eval_moves
        if res["promote"]:
            if process_index() == 0:
                self.store.set_best(latest)  # evaluator.py:43-46
            self.mesh.barrier()
            logger.info("promoted %s to best (winrate %.3f)", latest,
                        res["winrate"])
        return dict(self.metrics.log("evaluate", phase="evaluate",
                                     latest=latest, best=best, **res))

    # --- run-state checkpoint/resume (beyond the reference, which only
    # checkpoints model files — SURVEY.md §5) --------------------------

    @property
    def _run_state_suffix(self) -> str:
        # one replay window and generator per rank (shared workdir)
        return f"_p{process_index()}" if process_count() > 1 else ""

    def save_run_state(self) -> None:
        """Persist replay window + resign calibration + the generator's
        state so a crashed or preempted run resumes exactly."""
        sfx = self._run_state_suffix
        self.replay.save(os.path.join(self.workdir, f"replay{sfx}.npz"))
        meta = {
            "rng": self.generator.get_state().tolist(),
            "calibrator": {
                "min_values": self.calibrator.min_values,
                "current": self.calibrator.current,
            },
            "lr": self.lr,
            "plateau": self.plateau.state_dict() if self.plateau else None,
        }
        meta_path = os.path.join(self.workdir, f"run_state{sfx}.json")
        with open(meta_path + ".tmp", "w") as f:
            json.dump(meta, f)
        os.replace(meta_path + ".tmp", meta_path)

    def load_run_state(self) -> bool:
        sfx = self._run_state_suffix
        replay_path = os.path.join(self.workdir, f"replay{sfx}.npz")
        meta_path = os.path.join(self.workdir, f"run_state{sfx}.json")
        if not (os.path.exists(replay_path) and os.path.exists(meta_path)):
            return False
        self.replay = ReplayBuffer.load(
            replay_path, self.cfg.train.replay_window, self.cfg.go.size)
        with open(meta_path) as f:
            meta = json.load(f)
        self.generator.set_state(torch.tensor(meta["rng"], dtype=torch.uint8))
        self.calibrator.min_values = meta["calibrator"]["min_values"]
        self.calibrator.current = meta["calibrator"]["current"]
        if self.plateau is not None and meta.get("plateau"):
            self.plateau.load_state_dict(meta["plateau"])
        lr = meta.get("lr", self.lr)
        if lr != self.lr:
            self.set_lr(lr)
        return True

    def run(self, generations: int = 1, selfplay_games: int = 0):
        self.init_models()
        results = []
        for gen in range(generations):
            sp = self.selfplay_phase(selfplay_games)
            tr = self.train_phase()
            ev = self.evaluate_phase()
            self.save_run_state()
            results.append({"generation": gen, "selfplay": sp, "train": tr,
                            "evaluate": ev, "best": self.store.best_name()})
        return results

    # --- deployment-role loops (reference main_selfplay.py:9-29,
    # main_training.py:34-98, main_spe.py:10-35): split the generation
    # loop across processes that share the workdir. -------------------

    def run_selfplay_role(self, iterations: int = 0,
                          selfplay_games: int = 0):
        """Self-play server: generate games with the current best model,
        re-reading the best pointer each round (iterations=0 = forever)."""
        self.init_models()
        i = 0
        while iterations == 0 or i < iterations:
            self._segment_games = []
            self.selfplay_phase(selfplay_games)
            self._publish_segment()
            self.save_run_state()
            i += 1

    def run_train_role(self, iterations: int = 0):
        """Training server: continuously ingest replay segments
        published by selfplay-role processes and train (the run-state
        snapshot is the fallback when no segments exist)."""
        self.init_models()
        i = 0
        while iterations == 0 or i < iterations:
            self.ingest_segments()
            if len(self.replay) < self.cfg.train.batch_size:
                if not self._ingested_segments:
                    self.load_run_state()
                if len(self.replay) < self.cfg.train.batch_size:
                    time.sleep(1.0)
                    continue
            self.train_phase()
            i += 1

    def run_spe_role(self, iterations: int = 0, selfplay_games: int = 0):
        """Self-play + evaluate server (reference main_spe.py)."""
        self.init_models()
        i = 0
        while iterations == 0 or i < iterations:
            self._segment_games = []
            self.selfplay_phase(selfplay_games)
            self._publish_segment()
            self.evaluate_phase()
            self.save_run_state()
            i += 1


def main(argv=None):
    from sejonggo_torch.utils.metrics import setup_logging

    parser = argparse.ArgumentParser(description="sejonggo_torch pipeline")
    parser.add_argument("--preset", choices=["tiny", "strength", "full"],
                        default="tiny")
    parser.add_argument("--generations", type=int, default=1)
    parser.add_argument("--games", type=int, default=0,
                        help="self-play games per generation (0 = preset)")
    parser.add_argument("--workdir", default="runs/pipeline")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--archive-selfplay", action="store_true",
                        help="also write self-play games as SGF "
                        "(reference sgfsave.py behavior)")
    parser.add_argument("--role",
                        choices=["full", "selfplay", "train", "spe"],
                        default="full",
                        help="deployment role (reference main_selfplay/"
                        "main_training/main_spe); 'full' runs the closed "
                        "loop")
    parser.add_argument("--device", default=None,
                        help="torch device (default: this rank's card; "
                        "'cpu' to run on the CPU)")
    # several cards (replaces the reference's master/slave deployment):
    # run the SAME program once per card with these flags, or under
    # torchrun, which sets RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0 (several processes)")
    parser.add_argument("--num-hosts", type=int, default=0,
                        help="processes in all, one per card")
    parser.add_argument("--host-id", type=int, default=None,
                        help="this process's rank")
    parser.add_argument("--local-rank", type=int, default=None,
                        help="this process's card on its machine (needed "
                        "when the world spans more cards than this "
                        "machine has)")
    args = parser.parse_args(argv)

    if args.num_hosts > 1 or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_distributed(args.coordinator, args.num_hosts or None,
                         args.host_id, device=args.device,
                         local_rank=args.local_rank)

    cfg = {"tiny": small_9x9, "strength": strength_9x9,
           "full": full_19x19}[args.preset]()
    os.makedirs(args.workdir, exist_ok=True)
    setup_logging(os.path.join(args.workdir, cfg.log_dir))
    pipe = Pipeline(cfg, args.workdir, seed=args.seed, device=args.device)
    pipe.archive_selfplay = args.archive_selfplay
    if args.role == "selfplay":
        pipe.run_selfplay_role(args.generations, args.games)
    elif args.role == "train":
        pipe.run_train_role(args.generations)
    elif args.role == "spe":
        pipe.run_spe_role(args.generations, args.games)
    else:
        for r in pipe.run(args.generations, args.games):
            print(r)


if __name__ == "__main__":
    main()
