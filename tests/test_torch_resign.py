"""The port's ResignCalibrator (a numpy copy) against the JAX package's:
the same seeded GameBatches and game dicts, fed in the same order, give
the same thresholds, holdouts and calibrated value at every step."""
import numpy as np
import pytest

from sejonggo_tpu.actor.resign import ResignCalibrator as JCalibrator
from sejonggo_tpu.actor.selfplay import GameBatch as JGameBatch
from sejonggo_torch.actor import GameBatch, ResignCalibrator


def _batch(cls, rng, t, b):
    players = np.where(np.arange(t)[:, None] % 2 == 0, 1, -1) * np.ones((1, b), np.int32)
    return cls(
        boards=np.zeros((t, b, 1, 1, 17), np.int8),
        policy_targets=np.zeros((t, b, 2), np.float32),
        values=rng.uniform(-1, 1, (t, b)).astype(np.float32),
        actions=np.zeros((t, b), np.int32), players=players.astype(np.int32),
        move_valid=rng.rand(t, b) < 0.9, tree_fresh=np.zeros((t, b), bool),
        winners=rng.randint(-1, 2, b).astype(np.int32),
        resign_winners=np.zeros(b, np.int32),
        black_points=np.zeros(b), white_points=np.zeros(b),
        end_reasons=np.zeros(b, np.int32), num_moves=np.zeros(b, np.int32),
        model1_isblack=np.ones(b, bool))


@pytest.mark.parametrize("cap", [None, -0.8])
def test_batch_calibration_matches_jax(cap):
    rng = np.random.RandomState(0)
    j, t = (cls(holdout_percent=0.3, seed=4, cap=cap, window=40)
            for cls in (JCalibrator, ResignCalibrator))
    for step in range(12):
        jt, tt = j.thresholds(16), t.thresholds(16)
        assert np.array_equal(jt, tt, equal_nan=True)
        state = rng.get_state()
        j.observe(_batch(JGameBatch, rng, 20, 16))
        rng.set_state(state)
        t.observe(_batch(GameBatch, rng, 20, 16))
        assert j.current == t.current and j.min_values == t.min_values
    assert t.current is not None and len(t.min_values) == 40


def test_game_calibration_matches_jax():
    rng = np.random.RandomState(1)
    j, t = JCalibrator(seed=2, cap=-0.9), ResignCalibrator(seed=2, cap=-0.9)
    for g in range(300):
        n = rng.randint(0, 30)
        game = {"winner": int(rng.randint(-1, 2)),
                "players": np.where(np.arange(n) % 2 == 0, 1, -1),
                "values": rng.uniform(-1, 1, n).astype(np.float32),
                "holdout": bool(rng.rand() < 0.5)}
        j.observe_game(game)
        t.observe_game(game)
        jt, tt = j.threshold_for_new_game(), t.threshold_for_new_game()
        assert jt == tt or (np.isnan(jt) and np.isnan(tt))
        assert j.current == t.current
    assert t.current is not None and t.current <= -0.9
