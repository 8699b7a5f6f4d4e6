"""SGF and HDF5 files of the port (sejonggo_torch.io.sgf, io.h5data)
against the JAX package's: the parser gives equal dicts on the
handcrafted SGFs of tests/test_io.py and tests/test_kgs.py and on two
corpus games of runs/full19_r5, the writers give byte-equal SGF files,
and each side reads the other's HDF5 samples in the reference's
game_%05d/move_%03d/sample.h5 layout."""
import os
import pathlib

import numpy as np
import pytest

from sejonggo_tpu.io import h5data as jh5
from sejonggo_tpu.io import sgf as jsgf
from sejonggo_torch.actor import play_games
from sejonggo_torch.config import SearchConfig
from sejonggo_torch.io import h5data as th5
from sejonggo_torch.io import sgf as tsgf
from sejonggo_torch.nets import dummy_predict_fn
from test_torch_heuristics import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
CORPUS = REPO / "runs/full19_r5/corpus"
HANDCRAFTED = [
    "(;GM[1]FF[4]SZ[19]KM[0.5]HA[2]AB[pd][dp];W[dd];B[pp])",
    "(;GM[1]FF[4]SZ[9]KM[5.5]RE[B+2.5];B[cc];W[gg];B[cf];W[];B[ff])",
    "(;GM[1]FF[4]SZ[9]KM[0.5]HA[2]RE[W+R]AB[cc][gg];W[ee];B[cf])",
    "(;GM[1]SZ[9]KM[abc]C[a \\] b];B[tt](;W[aa])(;W[bb]))",
    "not an sgf at all ;;;[",
]


@pytest.mark.parametrize("text", HANDCRAFTED + [
    (CORPUS / name).read_text(errors="replace")
    for name in ("rollout_00_000.sgf", "rollout_01_023.sgf")])
def test_parse_sgf_matches_jax(text):
    assert tsgf.parse_sgf(text) == jsgf.parse_sgf(text)


def test_game_to_sgf_bytes_match_jax():
    moves = [(1, 2, 3), (-1, 4, 5), (1, 0, 9), (-1, 8, 8)]
    for kw in (dict(result="B+2.5", values=[0.1, -0.2, 0.3]),
               dict(result="W+R", black_name="a", white_name="b"),
               dict()):
        assert tsgf.game_to_sgf(9, 5.5, moves, **kw) == \
            jsgf.game_to_sgf(9, 5.5, moves, **kw)
    for a in (0, 80, 81, 100):
        assert tsgf.divmod_xy(a, 9) == jsgf.divmod_xy(a, 9)


def _games(b=3, moves=6):
    """A port GameBatch (numpy fields) of ``b`` short dummy-net games."""
    return play_games(dummy_predict_fn, size=9, komi=5.5,
                      search=SearchConfig(simulations=8, batch_size=4,
                                          use_symmetry=False),
                      game_batch=b, selfplay=True, stop_exploration=2,
                      max_moves=moves, device="cpu")


def test_save_game_sgf_bytes_match_jax(tmp_path):
    games = _games()
    for g in range(games.move_valid.shape[1]):
        paths = [mod.save_game_sgf(str(tmp_path / side), "model_3", g,
                                   size=9, komi=5.5, games=games,
                                   game_index=g, black_name="x")
                 for side, mod in (("jax", jsgf), ("port", tsgf))]
        data = [open(p, "rb").read() for p in paths]
        assert data[0] == data[1]
        parsed = tsgf.parse_sgf(data[1].decode())
        assert len(parsed["moves"]) == int(games.num_moves[g])


def test_h5_layout_round_trips_both_ways(tmp_path):
    games = _games(b=2, moves=4)
    n = {side: mod.save_self_play_data(str(tmp_path / side), "model_x",
                                       games, first_game_index=3)
         for side, mod in (("jax", jh5), ("port", th5))}
    assert n["jax"] == n["port"] == int(games.num_moves.sum())
    vt = games.value_targets()
    for g in range(2):
        t_valid = np.nonzero(games.move_valid[:, g])[0]
        for m, t in enumerate(t_valid):
            rel = os.path.join("model_x", f"game_{3 + g:05d}", f"move_{m:03d}")
            for writer in ("jax", "port"):
                d = str(tmp_path / writer / rel)
                for reader in (jh5, th5):
                    board, policy, value = reader.load_move_sample(d)
                    assert board.dtype == np.float32
                    assert np.array_equal(board, games.boards[t, g])
                    assert np.array_equal(policy, games.policy_targets[t, g])
                    assert value.shape == () and value == vt[t, g]
    assert sorted(os.listdir(tmp_path / "port" / "model_x")) == \
        sorted(os.listdir(tmp_path / "jax" / "model_x"))
