"""Sliding-window replay buffer (a copy of sejonggo_tpu/learn/replay.py,
kept here so the port never imports the JAX package; it is numpy only).

Replaces the reference's one-HDF5-file-per-move tree
(sgfsave.py:49-79) + directory-walking window with deletion
(data_generator.py:43-78, N_MOST_RECENT_GAMES).  Samples are kept in a
host-side ring buffer over MOVES; the window drops the oldest moves as
new games stream in, which is the same most-recent-games semantics at
scale without filesystem churn.  Boards are stored int8 (17 planes),
policy targets sparse-dense f32, value targets f32.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def game_samples(game: dict):
    """Extract (boards, policies, values) training rows from one
    continuous-actor game dict (value target = +-1 from the final
    winner in each move's player perspective, reference
    sgfsave.py:49-79 value_target semantics)."""
    boards = np.asarray(game["boards"])
    t = boards.shape[0]
    w = int(game["winner"])
    players = np.asarray(game["players"])
    values = (np.zeros(t, np.float32) if w == 0
              else np.where(players == w, 1.0, -1.0).astype(np.float32))
    return boards, np.asarray(game["policies"]), values


def save_segment(path: str, boards, policies, values) -> None:
    """Atomically write one replay segment (a batch of training rows).

    Segments are the split-role selfplay->train data path: the selfplay
    role appends one per phase, the train role ingests new ones each
    iteration — the TPU-build replacement for the reference's per-game
    scp push to the training server (selfplay_worker.py:123-124,
    scpy.py:68-107)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, boards=boards, policies=policies,
                            values=values)
    os.replace(tmp, path)


def load_segment(path: str):
    with np.load(path) as z:
        return z["boards"], z["policies"], z["values"]


class ReplayBuffer:
    def __init__(self, capacity_moves: int, size: int, seed: int = 0):
        self.capacity = int(capacity_moves)
        self.size = size
        a = size * size + 1
        self.boards = np.zeros((self.capacity, size, size, 17), np.int8)
        self.policies = np.zeros((self.capacity, a), np.float32)
        self.values = np.zeros((self.capacity,), np.float32)
        self.cursor = 0
        self.filled = 0
        self.total_games = 0
        self.total_moves = 0
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self.filled

    def add_game_batch(self, games) -> int:
        """Ingest a finished actor GameBatch; returns moves added."""
        vt = games.value_targets()  # (T, B)
        t, b = games.move_valid.shape
        mask = games.move_valid
        boards = games.boards[mask]
        policies = games.policy_targets[mask]
        values = vt[mask]
        self._append(boards, policies, values)
        self.total_games += b
        self.total_moves += int(mask.sum())
        return int(mask.sum())

    def add_game(self, game: dict) -> int:
        """Ingest one continuous-actor game dict (stacked per-move
        arrays: boards (T,N,N,17), policies (T,A), players (T,) plus the
        scalar winner; see ContinuousSelfPlay._harvest_game)."""
        boards, policies, values = game_samples(game)
        t = boards.shape[0]
        if t == 0:
            return 0
        self._append(boards, policies, values)
        self.total_games += 1
        self.total_moves += t
        return t

    def add_samples(self, boards, policies, values) -> int:
        """Ingest pre-extracted training rows (e.g. a replay segment
        published by a selfplay-role process — the split-role data path
        replacing the reference's per-game scp push,
        selfplay_worker.py:123-124)."""
        n = int(boards.shape[0])
        if n == 0:
            return 0
        self._append(boards, policies, values)
        self.total_moves += n
        return n

    def _append(self, boards, policies, values):
        n = boards.shape[0]
        idx = (self.cursor + np.arange(n)) % self.capacity
        self.boards[idx] = boards
        self.policies[idx] = policies
        self.values[idx] = values
        self.cursor = int((self.cursor + n) % self.capacity)
        self.filled = int(min(self.filled + n, self.capacity))

    def sample(self, batch_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Uniform sample over the window (reference train.py:44-60 picks
        random move files per step)."""
        idx = self._rng.randint(0, self.filled, size=batch_size)
        return (
            self.boards[idx].astype(np.float32),
            self.policies[idx],
            self.values[idx],
        )

    # --- persistence (part of checkpoint/resume; the reference never
    # checkpoints its replay window, SURVEY.md §5) -----------------------

    def save(self, path: str) -> None:
        """Atomic snapshot (tmp + os.replace): the split-role train
        server polls and loads this file while the selfplay role
        overwrites it (VERDICT r2 Weak #4 — a direct write risks a torn
        read crashing the reader)."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f,
                boards=self.boards[: self.filled],
                policies=self.policies[: self.filled],
                values=self.values[: self.filled],
                cursor=self.cursor, filled=self.filled,
                total_games=self.total_games, total_moves=self.total_moves,
            )
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, capacity_moves: int, size: int,
             seed: int = 0) -> "ReplayBuffer":
        buf = cls(capacity_moves, size, seed)
        with np.load(path) as z:
            n = int(z["filled"])
            n = min(n, buf.capacity)
            buf.boards[:n] = z["boards"][:n]
            buf.policies[:n] = z["policies"][:n]
            buf.values[:n] = z["values"][:n]
            buf.filled = n
            buf.cursor = int(z["cursor"]) % buf.capacity
            buf.total_games = int(z["total_games"])
            buf.total_moves = int(z["total_moves"])
        return buf
