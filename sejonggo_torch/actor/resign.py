"""Resignation-threshold calibration (a copy of
sejonggo_tpu/actor/resign.py, kept here so the port never imports the JAX
package; it is numpy only).

Reference semantics (self_play.py:293-340): 10% of games
(RESIGNATION_PERCENT) are played WITHOUT resignation; for each such
game, record the minimum predicted value over the eventual winner's
moves; the threshold is set so that at most RESIGNATION_ALLOWED_ERROR
(5%) of those games would have been resigned by the winner.

Deviation from the reference, on purpose: the reference indexes the
UNSORTED min-value list at int(0.05*len) (self_play.py:327-330), which
picks an arbitrary element; here the list is sorted so the threshold is
the actual 5th-percentile, which is the evident intent.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class ResignCalibrator:
    def __init__(self, holdout_percent: float = 0.10,
                 allowed_error: float = 0.05, seed: int = 0,
                 cap: Optional[float] = None, window: int = 2048):
        """cap: upper bound on the threshold (e.g. -0.8): resignation
        only ever fires below it.  Guards against the calibration
        collapse where a weak value head rates the EMPTY board below the
        calibrated threshold and every non-holdout game resigns at move
        0 (observed with untrained nets; the reference's equivalent
        guard is deleting zero-move games, selfplay_worker.py:115-118).
        window: only the most recent N holdout observations drive the
        percentile, so calibration tracks the current model."""
        self.holdout_percent = holdout_percent
        self.allowed_error = allowed_error
        self.cap = cap
        self.window = window
        self.min_values: list = []
        self._rng = np.random.RandomState(seed)
        self.current: Optional[float] = None

    def thresholds(self, batch: int) -> np.ndarray:
        """(B,) per-game thresholds; NaN disables resignation (the
        holdout and the uncalibrated cold start)."""
        t = np.full((batch,), np.nan, np.float32)
        if self.current is not None:
            use = self._rng.rand(batch) > self.holdout_percent
            t[use] = self.current
        self._last_holdout = np.isnan(t)
        return t

    # --- game-level API (continuous actor) ------------------------------

    def threshold_for_new_game(self) -> float:
        """Threshold assigned to one newly spawned game (NaN = holdout
        or uncalibrated)."""
        if self.current is not None and self._rng.rand() > self.holdout_percent:
            return float(self.current)
        return float("nan")

    def observe_game(self, game: dict) -> None:
        """Update from one finished continuous-actor game dict (stacked
        per-move arrays); only games that ran without a threshold
        contribute."""
        if not game.get("holdout", True):
            return
        w = int(game["winner"])
        players = np.asarray(game["players"])
        if w == 0 or players.size == 0:
            return
        mask = players == w
        if not mask.any():
            return
        vals = np.asarray(game["values"])[mask]
        self.min_values.append(float(vals.min()))
        self._recalibrate()

    def _recalibrate(self) -> None:
        self.min_values = self.min_values[-self.window:]
        idx = int(self.allowed_error * len(self.min_values))
        if idx > 0:
            t = float(np.sort(self.min_values)[idx])
            self.current = t if self.cap is None else min(t, self.cap)

    def observe(self, games) -> None:
        """Update calibration from a finished GameBatch: only games that
        ran without a threshold contribute (reference self_play.py:319-330)."""
        holdout = getattr(self, "_last_holdout", None)
        if holdout is None:
            return
        t, b = games.values.shape
        for g in range(b):
            if not holdout[g]:
                continue
            w = int(games.winners[g])
            if w == 0:
                continue
            mask = games.move_valid[:, g] & (games.players[:, g] == w)
            if not mask.any():
                continue
            self.min_values.append(float(games.values[mask, g].min()))
        self._recalibrate()
