"""The port's single-board engine API (sejonggo_torch.goenv.engine:
play_at, score, winner, area_counts, group_liberty_count, legal and
illegal masks, the side swap and show_board) against the JAX package's,
on random 9x9 games with passes and forced colours, and on one 19x19
corpus game of runs/full19_r5 replayed move by move."""
import pathlib

import jax
import numpy as np
import pytest
import torch

from sejonggo_tpu.goenv import engine as J
from sejonggo_tpu.io.sgf import parse_sgf
from sejonggo_torch.goenv import engine as T
from test_torch_heuristics import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# the JAX package's eager single-board helpers, jitted once
J_LIBS = jax.jit(J.group_liberty_count)
J_COLOR = jax.jit(J.color_board)
J_AREA = jax.jit(J.area_counts)
J_REAL = jax.jit(J.real_board)
J_SWAP = jax.jit(J._swap_sides)


def _same(jb, tb):
    assert np.array_equal(np.asarray(jb), tb.numpy())


def _compare_position(jb, tb, rng, komi):
    """Every single-board query on one position, JAX against the port."""
    n = tb.shape[0]
    assert np.array_equal(np.asarray(J.legal_moves_mask(jb)),
                          T.legal_moves_mask(tb).numpy())
    assert np.array_equal(np.asarray(J.illegal_moves_mask(jb)),
                          T.illegal_moves_mask(tb).numpy())
    assert int(J.current_player(jb)) == int(T.current_player(tb))
    real = T.real_board(tb)
    assert real.dtype == torch.int32
    assert np.array_equal(np.asarray(J_REAL(jb)), real.numpy())
    _same(J_SWAP(jb), T._swap_sides(tb))
    jw, jbp, jwp = J.score(jb, komi)
    tw, tbp, twp = T.score(tb, komi)
    assert (int(jw), float(jbp), float(jwp)) == (int(tw), float(tbp),
                                                 float(twp))
    assert tbp.dtype == twp.dtype == torch.float32
    assert int(J.winner(jb, komi)) == int(T.winner(tb, komi))
    assert np.array_equal(np.asarray(J_AREA(J_REAL(jb))),
                          T.area_counts(real).numpy())
    for color in (1, -1):
        assert np.array_equal(np.asarray(J_COLOR(J_REAL(jb), color)),
                              T.color_board(real, color).numpy())
    for _ in range(3):
        x, y = (int(v) for v in rng.randint(0, n, 2))
        for color in (1, -1):
            assert int(J_LIBS(jb, x, y, color)) == \
                int(T.group_liberty_count(tb, x, y, color))
    assert T.show_board(tb) == J.show_board(jb)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_games_match_jax(seed):
    rng = np.random.RandomState(seed)
    jb, tb = J.init_board(9), T.init_board(9, device=CPU)
    _same(jb, tb)
    for move in range(40):
        _compare_position(jb, tb, rng, 5.5)
        legal = np.nonzero(np.asarray(J.legal_moves_mask(jb))[:81])[0]
        r = rng.rand()
        if r < 0.08 or not len(legal):
            x, y = 0, 9                                 # pass
        else:
            x, y = (int(v) for v in divmod(int(rng.choice(legal)), 9)[::-1])
        # now and then the same colour twice (GTP's forced colour)
        color = None if r > 0.85 else (1 if rng.rand() < 0.5 else -1)
        jb, jp = J.play_at(jb, x, y, color)
        tb, tp = T.play_at(tb, x, y, color)
        assert jp == tp, f"mover differs at move {move}"
        _same(jb, tb)
    _compare_position(jb, tb, rng, 7.5)
    assert T.step(tb, 81).shape == tb.shape
    _same(J.step(jb, 81), T.step(tb, 81))


def test_corpus_game_19x19_matches_jax():
    parsed = parse_sgf((REPO / "runs/full19_r5/corpus/rollout_00_000.sgf")
                       .read_text())
    assert parsed["size"] == 19 and len(parsed["moves"]) > 50
    rng = np.random.RandomState(2)
    jb, tb = J.init_board(19), T.init_board(19, device=CPU)
    for i, (player, x, y) in enumerate(parsed["moves"]):
        jb, _ = J.play_at(jb, x, y, player)
        tb, _ = T.play_at(tb, x, y, player)
        if i % 40 == 0:
            _same(jb, tb)
    _same(jb, tb)
    _compare_position(jb, tb, rng, parsed["komi"])
    assert tb.device == CPU and tb.dtype == torch.int8
