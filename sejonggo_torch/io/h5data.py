"""HDF5 per-move training-sample export/import in the reference's layout
(port of sejonggo_tpu/io/h5data.py).

Reference counterpart: sgfsave.py:16-79 — one file per move at
<dir>/<model>/game_%05d/move_%03d/sample.h5 with datasets ``board``
(float32 (size, size, 17)), ``policy_target`` (size^2+1) and
``value_target`` (scalar).  The port trains from the in-memory
ReplayBuffer; this module is for data interchange with reference tooling
and for durable self-play archives.  ``h5py`` is imported when a function
is called, not when the module is: the card's machine has none, and only
the archive and export paths need it.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as e:  # pragma: no cover
        raise ImportError("h5py is required for HDF5 data export") from e
    return h5py


def save_move_sample(directory: str, board, policy_target, value_target) -> str:
    h5py = _h5py()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "sample.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("board", data=np.asarray(board, np.float32),
                         dtype=np.float32)
        f.create_dataset("policy_target",
                         data=np.asarray(policy_target, np.float32),
                         dtype=np.float32)
        f.create_dataset("value_target",
                         data=np.asarray(value_target, np.float32),
                         dtype=np.float32)
    return path


def save_self_play_data(base_dir: str, model_name: str, games,
                        first_game_index: int = 0) -> int:
    """Write every move of an actor GameBatch in the reference's layout
    (sgfsave.py:49-79).  Returns files written."""
    _h5py()
    vt = games.value_targets()
    written = 0
    t_max, b = games.move_valid.shape
    for g in range(b):
        game_dir = os.path.join(
            base_dir, model_name, "game_%05d" % (first_game_index + g))
        move_n = 0
        for t in range(t_max):
            if not games.move_valid[t, g]:
                continue
            save_move_sample(
                os.path.join(game_dir, "move_%03d" % move_n),
                games.boards[t, g], games.policy_targets[t, g], vt[t, g])
            move_n += 1
            written += 1
    return written


def load_move_sample(directory: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    h5py = _h5py()
    with h5py.File(os.path.join(directory, "sample.h5"), "r") as f:
        return (np.asarray(f["board"]), np.asarray(f["policy_target"]),
                np.asarray(f["value_target"]))
